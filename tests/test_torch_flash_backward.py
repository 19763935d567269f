"""The flash attention's gradient in the port against the JAX package.

The JAX model takes this gradient by autodiff of ``flash_attention_jnp``
(``repro.models.attention``); the port computes it in the FlashAttention-2
form from the forward's log-sum-exp: ``ref.flash_attention_bwd_ref``, the
plain version of the backward kernel (``csrc/flash_attention_bwd.cu``), and
the ``torch.autograd.Function`` behind ``ops.flash_attention`` (on a CPU
tensor its forward is the chunked plain version with the log-sum-exp and
its backward the plain backward).  Both are held to ``jax.vjp`` of
``flash_attention_jnp`` on numpy inputs from a seed: causal, windowed,
non-causal, Sq != Skv with ``q_offset`` (the encoder-decoder's
cross-attention and a continued block), GQA groups 1, 4, 5 and 6, head
dims 16, 64 and 120.

Bounds, max |port - JAX| over max |JAX| of each of dq, dk, dv: float32
2e-5 (both sum float32 products in another order; measured up to 1e-6);
bf16 2e-2, about three bf16 ulps (JAX differentiates the chunked scan,
rounding at each chunk's online-softmax correction and its cotangents to
bf16; the FA-2 form rounds P and dS to bf16 before their products, as the
kernel does; measured up to 7.6e-3).  A float64
``gradcheck`` holds the CPU path to finite differences.  The CUDA
kernel has no CPU mode: its wrapper refuses CPU tensors here and
``chip_smoke.py`` (phase L1) holds it to the plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    INSTANCES, MAX_SMEM, bwd_schedule, bwd_smem_bytes, bwd_tile_class,
    flash_attention_bwd_cuda)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_chunked)

# b, sq, skv, kh, g, d, causal, window, q_offset
CASES = [
    (2, 40, 40, 2, 4, 16, True, 0, 0),        # causal, G 4
    (1, 48, 48, 1, 5, 64, True, 16, 0),       # windowed, G 5 (hymba)
    (2, 24, 24, 3, 1, 16, False, 0, 0),       # non-causal (the encoder)
    (1, 19, 33, 2, 1, 64, False, 0, 0),       # cross-attention, Sq < Skv
    (2, 13, 40, 1, 6, 16, True, 0, 27),       # q_offset, G 6 (dbrx)
    (1, 21, 50, 2, 4, 120, True, 24, 29),     # q_offset and a window, D 120
    (1, 70, 70, 2, 4, 120, True, 0, 0),       # danube's heads
]
LIMITS = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(case, dtype, seed):
    b, sq, skv, kh, g, d = case[:6]
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, sq, kh * g, d), rng.randn(b, skv, kh, d),
            rng.randn(b, skv, kh, d), rng.randn(b, sq, kh * g, d)]
    arrs = [a.astype(np.float32) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    jj = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    return tt, jj


def _jax_grads(jj, causal, window, q_offset):
    q, k, v, do = jj
    _, vjp = jax.vjp(lambda q, k, v: flash_attention_jnp(
        q, k, v, causal=causal, window=window, q_offset=q_offset), q, k, v)
    return [np.asarray(x, np.float32) for x in vjp(do)]


def _rel(got, want):
    got = got.float().numpy()
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_backward_matches_jax_vjp(case, dtype):
    causal, window, q_offset = case[6:]
    (q, k, v, do), jj = _inputs(case, dtype, seed=len(case) + case[1])
    want = _jax_grads(jj, causal, window, q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = flash_attention_chunked(q, k, v, with_lse=True, **kw)
    ref = flash_attention_bwd_ref(q, k, v, out, do, lse, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = ops.flash_attention(*leaves, **kw)
    assert torch.equal(got.detach(), out)
    auto = torch.autograd.grad(got, leaves, do)
    for name, r, a, w in zip(("dq", "dk", "dv"), ref, auto, want):
        assert r.dtype == q.dtype and a.dtype == q.dtype
        assert torch.equal(r, a), name
        assert _rel(r, w) <= LIMITS[dtype], (name, _rel(r, w))


def test_lse_is_the_rows_log_sum_exp():
    """The chunked forward's lse equals logsumexp of the masked scaled
    scores, in the kernel's (B, H, Sq) layout."""
    case = (2, 21, 50, 2, 4, 16, True, 24, 29)
    (q, k, v, _), _ = _inputs(case, "float32", 3)
    _, lse = flash_attention_chunked(q, k, v, causal=True, window=24,
                                     q_offset=29, with_lse=True)
    b, sq, h, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q * d ** -0.5,
                     k.repeat_interleave(h // k.shape[2], dim=2))
    qp = 29 + torch.arange(sq)[:, None]
    kp = torch.arange(k.shape[1])[None, :]
    s = s.masked_fill(~((kp <= qp) & (kp > qp - 24)), -torch.inf)
    assert lse.shape == (b, h, sq)
    assert torch.allclose(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("causal,window,q_offset,skv", [
    (True, 0, 0, 6), (True, 3, 4, 9), (False, 0, 0, 7)])
def test_gradcheck_float64(causal, window, q_offset, skv):
    gen = torch.Generator().manual_seed(skv)
    sq = skv - q_offset if causal else 5
    q = torch.randn(1, sq, 2, 4, dtype=torch.float64, generator=gen)
    k = torch.randn(1, skv, 1, 4, dtype=torch.float64, generator=gen)
    v = torch.randn(1, skv, 1, 4, dtype=torch.float64, generator=gen)
    args = [t.requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=causal,
                                            window=window, q_offset=q_offset),
        args)


def test_no_grad_path_is_the_plain_forward():
    """Without a gradient the entry point is the forward as it was: no
    autograd node, the chunked version's output."""
    (q, k, v, _), _ = _inputs(CASES[0], "float32", 0)
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    assert torch.equal(out, flash_attention_chunked(q, k, v, causal=True))
    with torch.no_grad():
        qg = q.clone().requires_grad_()
        assert ops.flash_attention(qg, k, v, causal=True).grad_fn is None


def test_backward_wrapper_refuses_cpu_tensors():
    (q, k, v, do), _ = _inputs(CASES[0], "float32", 0)
    out, lse = flash_attention_chunked(q, k, v, causal=True, with_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_fits_shared_memory_at_every_head_dim(dtype):
    """Both backward CTAs fit the H100's shared memory at every head dim
    of the forward's instances, in both dtypes."""
    for d in INSTANCES:
        assert bwd_smem_bytes(d, dtype) <= MAX_SMEM, d


# sq, skv, g, causal, window, q_offset
SCHEDULE_CASES = [
    (300, 300, 4, True, 0, 0),        # causal, G 4
    (250, 250, 5, True, 64, 0),       # windowed, G 5 (hymba)
    (200, 200, 1, False, 0, 0),       # non-causal
    (130, 390, 1, False, 0, 0),       # cross-attention, Sq < Skv
    (77, 300, 6, True, 0, 223),       # q_offset, G 6 (dbrx)
    (150, 420, 4, True, 100, 270),    # q_offset and a window
    (260, 200, 3, False, 90, 0),      # a window without causality, Sq > Skv
]


def _visible(sq, skv, causal, window, q_offset):
    p = q_offset + np.arange(sq)[:, None]
    t = np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= t <= p
    if window > 0:
        ok &= t > p - window
    return ok


def _walk(kind, sched, sq):
    """(CTA, positions, first key) of every (rows, streamed tile) step that
    the tensor-core backward's kernel ``kind`` runs: dQ's consumers each own
    their query rows; dK/dV's two consumers share the unit's keys, one
    forming dV and the other dK, so a step stands for both."""
    bq = sched["bq"]
    for x, cta in enumerate(sched[kind]):
        for unit, first, n in cta:
            for j in range(n):
                if kind == "dkv":
                    p0 = first + j * bq
                    yield x, range(p0, min(p0 + bq, sq)), unit * K.BWD_TILE
                    continue
                for w in range(K.BWD_CONS):
                    p0 = (unit * K.BWD_CONS + w) * bq
                    yield (x, range(p0, min(p0 + bq, sq)),
                           first + j * K.BWD_TILE)


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_bwd_schedule_covers_every_visible_pair_once(case, kind):
    """Each kernel's CTAs, over the tiles ``bwd_schedule`` gives them and
    the tiles ``bwd_tile_class`` does not skip, cover every visible (query
    row, key) pair exactly once: every G head of a position rides in the
    same tile row block, so positions stand for rows.  A FULL tile has
    every pair visible (no mask needed), an EMPTY one none."""
    sq, skv, g, causal, window, q_offset = case
    vis = _visible(sq, skv, causal, window, q_offset)
    sched = bwd_schedule(sq, skv, g, causal, window, q_offset)
    assert sched["bq"] * g <= K.BWD_TILE < (sched["bq"] + 1) * g
    count = np.zeros((sq, skv), int)
    for _, pos, t0 in _walk(kind, sched, sq):
        cls = bwd_tile_class(q_offset + pos.start, q_offset + pos.stop - 1,
                             t0, skv, causal, window)
        block = vis[pos.start:pos.stop, t0:min(t0 + K.BWD_TILE, skv)]
        if cls == K.EMPTY:
            assert not block.any()
            continue
        if cls == K.FULL:
            assert block.all() and t0 + K.BWD_TILE <= skv
        count[pos.start:pos.stop, t0:min(t0 + K.BWD_TILE, skv)] += 1
    assert (count[vis] == 1).all()
    assert sum(len(c) for c in sched[kind]) >= 1


def test_bwd_schedule_balances_the_causal_work():
    """At L1's main shape (h2o-danube-3-4b's heads over 4,096 causal
    positions) the dK/dV CTA that walks the most tiles walks at most 1.25x
    the mean (the first key block alone walked 512 tiles of 32 rows against
    a mean of 260 before the pairing), and so does the dQ CTA."""
    sched = bwd_schedule(4096, 4096, 4, True, 4096, 0)
    for kind in ("dkv", "dq"):
        work = [sum(n for _, _, n in cta) for cta in sched[kind]]
        assert max(work) <= 1.25 * np.mean(work), (kind, max(work),
                                                     np.mean(work))
    # the pairs: CTA x holds units x and 63 - x of the 64 key blocks
    assert [[u for u, _, _ in c] for c in sched["dkv"]] == [
        [x, 63 - x] for x in range(32)]


@pytest.mark.parametrize("d", [16, 64, 96, 120, 128])
def test_tensor_core_backward_shared_memory_layout(d):
    """bf16 at d <= 128: dQ holds 2 x BWD_CONS own panels a 64-column chunk
    of the head dim (scaled Q, dO) and BWD_STAGES ring stages of two
    streamed panels a chunk (K, V) with 16 bytes of mbarriers a stage;
    dK/dV two own panels a chunk (K, V), the same ring of scaled Q and dO
    with 512 bytes of lse and Delta a stage, two 16 KiB float32 P^T tiles,
    and 16 bytes more of mbarriers; each 1024 bytes of alignment.  The
    larger fits an SM."""
    chunks = -(-d // 64)
    dq = (8192 * chunks * (2 * K.BWD_CONS + 2 * K.BWD_STAGES)
          + 16 * K.BWD_STAGES + 1024)
    dkv = (8192 * chunks * (2 + 2 * K.BWD_STAGES) + 2 * 16384
           + 512 * K.BWD_STAGES + 16 * K.BWD_STAGES + 16 + 1024)
    assert bwd_smem_bytes(d, torch.bfloat16) == max(dq, dkv) <= MAX_SMEM
