"""The port's paged decode attention against the JAX package.

``paged_decode_attention_ref`` (the CUDA kernel's plain version and the
port's CPU path, reached through ``ops.paged_decode_attention``) against
three references, on float32 inputs made with numpy from a seed: the JAX
``paged_decode_attention_ref``, the NumPy oracle
``paged_decode_attention_np``, and the JAX Pallas kernel in interpret mode
merged by ``merge_partials``, as ``tests/test_serving_paged.py`` runs it.
The cases are that test's four shapes plus head_dim 120 with four query
heads per kv head (h2o-danube-3-4b's attention) unwindowed and under a
window that masks, all with shuffled physical pages and page 0 as the dump
page.  Tolerance 2e-5, the reference test's own (float32 softmax and dot
products summed in another order).

The speculative verify: ``paged_verify_attention_ref`` (reached through
``ops.paged_verify_attention``) against the JAX Pallas verify kernel in
interpret mode (merged and laid out as the JAX ``ops`` does) and against
the NumPy oracle ``paged_verify_attention_np``, at 2e-5, with a window case
and G > 1.  Verify is never held to decode by bit equality here (the JAX
reference itself is not, ROADMAP C1); position s is held to the decode
plain version at ``lens + s`` at 2e-5.

The dense-cache decode: ``ops.decode_attention`` (the CPU path,
``decode_attention_ref``) against the JAX ``decode_attention`` (the dense
Pallas kernel in interpret mode, its splits merged) at
``tests/test_kernels.py``'s five cases — ragged T of 700 and a window of
128 among them — with the valid length given as a scalar and per sequence
(B,), at 2e-5.

The CUDA kernels have no CPU mode; they are held against these plain
versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.decode_attention.kernel import (  # noqa: E402
    paged_decode_attention_kernel, paged_verify_attention_kernel)
from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode, merge_partials as jax_merge)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as jax_dense_ref, paged_decode_attention_np,
    paged_decode_attention_ref as jax_ref,
    paged_verify_attention_np as jax_verify_np)
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda, paged_decode_attention_cuda,
    paged_verify_attention_cuda)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, gather_pages, paged_verify_attention_np)

CASES = [   # b, h, kh, d, ps, p_max, window, lens
    (3, 8, 2, 64, 16, 8, 0, (100, 17, 128)),      # GQA, ragged
    (2, 4, 4, 32, 8, 4, 0, (31, 1)),              # MHA, non-tile lens
    (2, 8, 2, 64, 16, 8, 24, (100, 77)),          # sliding window
    (1, 4, 1, 128, 32, 2, 0, (64,)),              # single kv head, full pages
    (3, 16, 4, 120, 16, 8, 0, (1, 57, 128)),      # danube heads: D=120, G=4
    (3, 16, 4, 120, 16, 8, 40, (1, 90, 128)),     # ... under a masking window
]


def _inputs(b, h, kh, d, ps, p_max, lens, seed=0):
    rng = np.random.RandomState(seed)
    n_pages = 1 + b * p_max
    q = rng.randn(b, 1, h, d).astype(np.float32)
    kp = rng.randn(n_pages, ps, kh, d).astype(np.float32)
    vp = rng.randn(n_pages, ps, kh, d).astype(np.float32)
    # shuffled physical ids; unused block-table entries point at page 0
    bt = np.zeros((b, p_max), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    for i in range(b):
        n_used = -(-int(lens[i]) // ps)
        bt[i, :n_used] = perm[i * p_max: i * p_max + n_used]
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _port(q, kp, vp, bt, lens, window):
    out = ops.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(lens), window=window)
    return out.numpy()


@pytest.mark.parametrize("b,h,kh,d,ps,p_max,window,lens", CASES)
def test_plain_version_matches_three_references(b, h, kh, d, ps, p_max,
                                                window, lens):
    q, kp, vp, bt, ln = _inputs(b, h, kh, d, ps, p_max, lens)
    launches = ops.launches
    got = _port(q, kp, vp, bt, ln, window)
    assert ops.launches == launches          # a CPU tensor launches nothing
    assert got.shape == q.shape and got.dtype == np.float32
    oracle = paged_decode_attention_np(q, kp, vp, bt, ln, window=window)
    ref = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(kp),
                             jnp.asarray(vp), jnp.asarray(bt),
                             jnp.asarray(ln), window=window))
    o, m, l = paged_decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln), window=window, interpret=True)
    pallas = np.asarray(jax_merge(o, m, l)).reshape(q.shape)
    for want in (oracle, ref, pallas):
        assert float(np.max(np.abs(got - want))) < 2e-5


@pytest.mark.parametrize("case", [CASES[0], CASES[5]])
def test_dense_plain_version_matches_jax(case):
    """The dense-cache body the paged version runs after its gather, on
    per-sequence lens, against the JAX ``decode_attention_ref`` at 2e-5."""
    b, h, kh, d, ps, p_max, window, lens = case
    rng = np.random.RandomState(1)
    t = p_max * ps
    q = rng.randn(b, 1, h, d).astype(np.float32)
    kc, vc = (rng.randn(b, t, kh, d).astype(np.float32) for _ in range(2))
    ln = np.asarray(lens, np.int32)
    got = decode_attention_ref(*(torch.from_numpy(a) for a in (q, kc, vc, ln)),
                               window=window).numpy()
    want = np.asarray(jax_dense_ref(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(ln),
                                    window=window))
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) < 2e-5


def test_gather_pages_is_the_block_table_view():
    _, kp, _, bt, _ = _inputs(2, 4, 2, 16, 8, 4, (20, 9))
    dense = gather_pages(torch.from_numpy(kp), torch.from_numpy(bt)).numpy()
    assert dense.shape == (2, 32, 2, 16)
    for i in range(2):
        for j in range(4):
            assert np.array_equal(dense[i, j * 8:(j + 1) * 8], kp[bt[i, j]])


def test_fully_masked_row_keeps_the_jax_reference_behaviour():
    """No valid position (lens 0): the plain version, like the JAX
    reference, gives the mean of every gathered V; the NumPy oracle gives 0
    (and so does the CUDA kernel).  The serving path never attends over
    fewer than one position."""
    q, kp, vp, bt, _ = _inputs(2, 4, 2, 16, 8, 4, (20, 9))
    ln = np.array([0, 9], np.int32)
    got = _port(q, kp, vp, bt, ln, 0)
    ref = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(kp),
                             jnp.asarray(vp), jnp.asarray(bt),
                             jnp.asarray(ln)))
    assert float(np.max(np.abs(got - ref))) < 2e-5
    mean_v = vp[bt[0]].reshape(-1, 2, 16).mean(0)          # (K, D)
    assert np.allclose(got[0, 0], np.repeat(mean_v, 2, axis=0), atol=2e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, kp, vp, bt, ln = _inputs(1, 4, 2, 16, 8, 2, (9,))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_cuda(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(bt), torch.from_numpy(ln))


VERIFY_CASES = [   # b, s, h, kh, d, ps, p_max, window, lens (of query 0)
    (3, 4, 8, 2, 64, 16, 8, 0, (60, 1, 124)),     # GQA G=4, ragged
    (2, 3, 4, 4, 32, 8, 4, 0, (20, 5)),           # MHA
    (2, 3, 8, 2, 64, 16, 8, 24, (90, 40)),        # sliding window
    (2, 8, 16, 4, 120, 16, 8, 40, (1, 100)),      # danube heads, k = 8
]


def _verify_inputs(b, s, h, kh, d, ps, p_max, lens, seed=0):
    q1, kp, vp, bt, ln = _inputs(b, h, kh, d, ps, p_max,
                                 [n + s - 1 for n in lens], seed)
    q = np.random.RandomState(seed + 1).randn(b, s, h, d).astype(np.float32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("b,s,h,kh,d,ps,p_max,window,lens", VERIFY_CASES)
def test_verify_plain_version_matches_kernel_and_oracle(b, s, h, kh, d, ps,
                                                        p_max, window, lens):
    q, kp, vp, bt, ln = _verify_inputs(b, s, h, kh, d, ps, p_max, lens)
    got = ops.paged_verify_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(ln), window=window).numpy()
    assert got.shape == (b, s, h, d)
    o, m, l = paged_verify_attention_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln), window=window, interpret=True)
    g = h // kh
    kern = np.asarray(jax_merge(o, m, l)).reshape(b, kh, s, g, d).transpose(
        0, 2, 1, 3, 4).reshape(b, s, h, d)
    oracle = jax_verify_np(q, kp, vp, bt, ln, window=window)
    assert float(np.max(np.abs(got - kern))) < 2e-5
    assert float(np.max(np.abs(got - oracle))) < 2e-5
    # the port's copy of the oracle is the reference's, bit for bit
    assert np.array_equal(paged_verify_attention_np(q, kp, vp, bt, ln,
                                                    window=window), oracle)
    # position s is the decode of its query at lens + s
    for j in range(s):
        dec = _port(np.ascontiguousarray(q[:, j:j + 1]), kp, vp, bt, ln + j,
                    window)
        assert float(np.max(np.abs(got[:, j:j + 1] - dec))) < 2e-5


def test_verify_cuda_wrapper_refuses_cpu_tensors():
    q, kp, vp, bt, ln = _verify_inputs(1, 3, 4, 2, 16, 8, 2, (5,))
    with pytest.raises(ValueError, match="CUDA"):
        paged_verify_attention_cuda(*[torch.from_numpy(a)
                                      for a in (q, kp, vp, bt, ln)])


DENSE_CASES = [   # b, t, h, kh, d, window, pos (tests/test_kernels.py)
    (2, 1024, 8, 2, 64, 0, 700),
    (1, 2048, 4, 4, 128, 256, 1500),
    (3, 512, 6, 3, 32, 0, 1),
    (2, 700, 8, 2, 64, 0, 650),     # T not a multiple of the split
    (1, 700, 4, 2, 64, 128, 700),   # ragged tail + window
]


@pytest.mark.parametrize("per_sequence", [False, True])
@pytest.mark.parametrize("b,t,h,kh,d,window,pos", DENSE_CASES)
def test_dense_decode_matches_jax_kernel(b, t, h, kh, d, window, pos,
                                         per_sequence):
    rng = np.random.RandomState(3)
    q = rng.randn(b, 1, h, d).astype(np.float32)
    kc, vc = (rng.randn(b, t, kh, d).astype(np.float32) for _ in range(2))
    if per_sequence:   # every row at its own length, the last at ``pos``
        lens = np.maximum(1, pos - 37 * np.arange(b)[::-1]).astype(np.int32)
    else:
        lens = pos
    launches = ops.dense_launches
    got = ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lens) if per_sequence else lens,
        window=window).numpy()
    assert ops.dense_launches == launches    # a CPU tensor launches nothing
    assert got.shape == q.shape and got.dtype == np.float32
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(lens),
                                 window=window, bs=256))
    assert float(np.max(np.abs(got - want))) < 2e-5


def test_dense_cuda_wrapper_refuses_cpu_tensors():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 1, 4, 16).astype(np.float32))
    kc = torch.from_numpy(rng.randn(2, 30, 2, 16).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q, kc, kc.clone(),
                              torch.tensor([5, 30], dtype=torch.int32))
