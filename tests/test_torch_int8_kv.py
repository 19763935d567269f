"""int8 KV caches and page pools of the port against the JAX package.

``kv_cache_dtype="int8"`` stores K and V as int8 with a float32 scale per
(position, kv head) (``_quant_kv``); each decode or verify step
dequantizes a dense view of the layer's cache and attends over it.  Held
here, on the float32 smoke configs with the JAX parameters carried over by
``convert.model_params_from_numpy``:

- ``_quant_kv`` gives int8 values and float32 scales bit-identical to
  JAX's on seeded inputs (float32 and bf16);
- the int8 prefill cache, its growth by ``pad_cache`` and the pools
  ``prefill_into_pages`` fills;
- dense ``decode_step`` and ``decode_step_paged`` logits, and one
  ``verify_step_paged`` of four positions;
- within the port, paged == dense token for token in the model dtype (the
  twin of ``tests/test_serving_paged.py``'s
  ``test_paged_decode_matches_dense[int8]``);
- the dense multi-position attention branch against JAX's
  ``verify_attention_jnp``.

Tolerances.  The two packages' float32 K/V differ by their summation
order, up to ~4e-5 relative after a few layers (``tests/test_torch_
models.py``).  An element that close to a rounding midpoint quantizes one
step apart: with 127 steps to the row's max, about 2 x 127 x 4e-5 ~ 1e-2
of the elements can flip.  So the int8 values agree to one step
(``INT8_STEP``) on all but ``INT8_FLIP_SHARE`` = 1e-2 of the elements, and
the scales to 1e-5 relative.  A flipped element moves its dequantized
value by one step (at most 1/127 of the row's max), which the attention
averages over positions and heads: logits are held to
max |port - JAX| <= ``LOGIT_REL`` = 1e-3 * max(1, max |JAX|), ten times
the float32 bound of ``tests/test_torch_models.py``, and the greedy
tokens must be equal.  (gemma3-4b's smoke config, the deepest, flips
1.2e-3 of its prefill cache and moves its logits by 1.4e-4 relative.)
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.attention import verify_attention_jnp  # noqa: E402
from repro.models.transformer import _quant_kv as jax_quant  # noqa: E402
from repro.models.zoo import pad_cache as jax_pad  # noqa: E402
from repro.models.zoo import prefill_into_pages as jax_pip  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common import cast_tree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import attention_block  # noqa: E402
from repro_torch.models.transformer import _quant_kv  # noqa: E402
from repro_torch.models.zoo import (pad_cache,  # noqa: E402
                                    pages_per_request, prefill_into_pages)

ARCHS = ["h2o-danube-3-4b", "internlm2-20b", "qwen2-72b", "gemma3-4b"]
INT8_STEP = 1
INT8_FLIP_SHARE = 1e-2
LOGIT_REL = 1e-3


def _close(got, want, rel=LOGIT_REL):
    want = np.asarray(want, np.float32)
    tol = rel * max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(np.asarray(got, np.float32) - want)))
    assert err <= tol, (err, tol)


def _int8_close(got, want):
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert int(diff.max(initial=0)) <= INT8_STEP
    assert float((diff > 0).mean()) <= INT8_FLIP_SHARE


def _leaf_close(key, got, want):
    if key in ("k", "v"):
        assert got.dtype == torch.int8 and np.asarray(want).dtype == np.int8
        _int8_close(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        _close(got.numpy(), want, rel=1e-5)


def _pair(arch, seed=0):
    """(jax model, jax float32 params, port model, port params), int8 KV."""
    jc = dataclasses.replace(jax_smoke(arch), dtype=jnp.float32,
                             kv_cache_dtype="int8")
    pc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                             kv_cache_dtype="int8")
    jm = jax_build(jc)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(seed)))
    pm = build_model(pc)
    pp = convert.model_params_from_numpy(pc, jax.tree.map(np.asarray, jp),
                                         "cpu")
    return jm, jp, pm, pp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((4, 1, 3, 16), 1.0),
                                         ((2, 9, 4, 120), 30.0),
                                         ((3, 5, 2, 8), 1e-3)])
def test_quant_kv_is_bit_identical_to_jax(shape, scale, dtype):
    x = (np.random.RandomState(sum(shape)).randn(*shape) * scale
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: the 1e-8 floor
    x[1, 0, 0, :4] = [0.5, -0.5, 1.5, 127.0]   # halves round to even
    q_ref, s_ref = jax_quant(jnp.asarray(x).astype(getattr(jnp, dtype)))
    q, s = _quant_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(q_ref))
    assert np.array_equal(s.numpy(), np.asarray(s_ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_prefill_cache_and_pools_match_jax(arch):
    jm, jp, pm, pp = _pair(arch)
    rng = np.random.RandomState(0)
    toks = rng.randint(1, jm.cfg.vocab_size, (2, 13)).astype(np.int32)
    jcache, jlog = jm.prefill(jp, jnp.asarray(toks))
    pcache, plog = pm.prefill(pp, torch.from_numpy(toks))
    _close(plog.numpy(), jlog)
    for jseg, pseg in zip(jcache["segs"], pcache["segs"]):
        for jl, pl in zip(jseg, pseg):
            assert set(pl) == set(jl) == {"k", "v", "k_scale", "v_scale"}
            for key in pl:
                assert tuple(pl[key].shape) == jl[key].shape
                _leaf_close(key, pl[key], jl[key])
    # pad_cache grows the values and the scales
    jg, pg = jax_pad(jcache, 24), pad_cache(pcache, 24)
    empty = pm.empty_cache(2, 24, device="cpu")
    for jseg, pseg, eseg in zip(jg["segs"], pg["segs"], empty["segs"]):
        for jl, pl, el in zip(jseg, pseg, eseg):
            for key in pl:
                assert tuple(pl[key].shape) == jl[key].shape \
                    == tuple(el[key].shape)
                assert pl[key].dtype == el[key].dtype
                _leaf_close(key, pl[key], jl[key])
    # one request scattered into shuffled pages
    ps, n_pages = 8, 9
    ids = np.array([5, 2], np.int32)
    jstate = jax_pip(jm.empty_paged_state(1, n_pages, ps),
                     jm.prefill(jp, jnp.asarray(toks[:1]))[0],
                     jnp.asarray(ids), 0, ps)
    pstate = pm.empty_paged_state(1, n_pages, ps, device="cpu")
    prefill_into_pages(pstate, pm.prefill(pp, torch.from_numpy(toks[:1]))[0],
                       torch.from_numpy(ids), 0, ps)
    for jseg, pseg in zip(jstate["segs"], pstate["segs"]):
        for jl, pl in zip(jseg, pseg):
            for key in pl:
                assert tuple(pl[key].shape) == jl[key].shape
                _leaf_close(key, pl[key], jl[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_dense_decode_step_matches_jax(arch):
    jm, jp, pm, pp = _pair(arch, seed=3)
    toks = np.random.RandomState(3).randint(
        1, jm.cfg.vocab_size, (2, 15)).astype(np.int32)
    jcache, _ = jm.prefill(jp, jnp.asarray(toks[:, :-1]))
    pcache, _ = pm.prefill(pp, torch.from_numpy(toks[:, :-1]))
    jcache, pcache = jax_pad(jcache, 24), pad_cache(pcache, 24)
    last = toks[:, -1:]
    vocab = jm.cfg.vocab_size
    step = jax.jit(jm.decode_step)
    for _ in range(4):
        jcache, jlog = step(jp, jcache, jnp.asarray(last))
        pcache, plog = pm.decode_step(pp, pcache, torch.from_numpy(last))
        assert plog.dtype == torch.float32
        _close(plog.numpy(), jlog)
        nxt = np.asarray(jlog)[:, :vocab].argmax(-1).astype(np.int32)
        assert np.array_equal(plog.numpy()[:, :vocab].argmax(-1), nxt)
        last = nxt[:, None]
    for jseg, pseg in zip(jcache["segs"], pcache["segs"]):
        for jl, pl in zip(jseg, pseg):
            for key in pl:
                _leaf_close(key, pl[key], jl[key])


def _paged_setup(jm, jp, pm, pp, plens, s_extra, seed):
    """Prefill each prompt alone into shuffled pages of both packages.
    Returns (JAX state, port state, block table, lens, last tokens)."""
    rng = np.random.RandomState(seed)
    b, ps, p_max = len(plens), 8, 4
    n_pages = 1 + b * p_max
    jstate = jm.empty_paged_state(b, n_pages, ps)
    pstate = pm.empty_paged_state(b, n_pages, ps, device="cpu")
    bt = np.zeros((b, p_max), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    last = np.zeros((b, 1), np.int32)
    for i, plen in enumerate(plens):
        toks = rng.randint(1, jm.cfg.vocab_size, (plen + 1,)).astype(np.int32)
        n_used = pages_per_request(plen, s_extra, ps)
        bt[i, :n_used] = perm[i * p_max:i * p_max + n_used]
        bucket = -(-plen // ps) * ps
        pt = np.zeros((1, bucket), np.int32)
        pt[0, :plen] = toks[:-1]
        jcache, _ = jm.prefill(jp, jnp.asarray(pt))
        pcache, _ = pm.prefill(pp, torch.from_numpy(pt))
        ids = bt[i, :bucket // ps]
        jstate = jax_pip(jstate, jcache, jnp.asarray(ids), i, ps)
        prefill_into_pages(pstate, pcache, torch.from_numpy(ids), i, ps)
        last[i, 0] = toks[-1]
    return jstate, pstate, bt, np.asarray(plens, np.int32), last


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_paged_decode_matches_jax(arch):
    jm, jp, pm, pp = _pair(arch, seed=1)
    jstate, pstate, bt, lens, last = _paged_setup(jm, jp, pm, pp,
                                                  [5, 11, 16], 6, seed=1)
    step = jax.jit(jm.decode_step_paged)
    vocab = jm.cfg.vocab_size
    for _ in range(6):
        jstate, jlog = step(jp, jstate, jnp.asarray(last), jnp.asarray(bt),
                            jnp.asarray(lens))
        _, plog = pm.decode_step_paged(pp, pstate, torch.from_numpy(last),
                                       torch.from_numpy(bt),
                                       torch.from_numpy(lens))
        _close(plog.numpy(), jlog)
        nxt = np.asarray(jlog)[:, :vocab].argmax(-1).astype(np.int32)
        assert np.array_equal(plog.numpy()[:, :vocab].argmax(-1), nxt)
        last, lens = nxt[:, None], lens + 1
    for jseg, pseg in zip(jstate["segs"], pstate["segs"]):
        for jl, pl in zip(jseg, pseg):
            for key in pl:
                _leaf_close(key, pl[key], jl[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_paged_verify_matches_jax(arch):
    jm, jp, pm, pp = _pair(arch, seed=2)
    s_q = 4
    jstate, pstate, bt, lens, last = _paged_setup(jm, jp, pm, pp,
                                                  [5, 11, 16], s_q, seed=2)
    rng = np.random.RandomState(3)
    toks = np.concatenate([last, rng.randint(
        1, jm.cfg.vocab_size, (len(lens), s_q - 1)).astype(np.int32)], 1)
    jstate, jlog = jax.jit(jm.verify_step_paged)(
        jp, jstate, jnp.asarray(toks), jnp.asarray(bt), jnp.asarray(lens))
    _, plog = pm.verify_step_paged(pp, pstate, torch.from_numpy(toks),
                                   torch.from_numpy(bt),
                                   torch.from_numpy(lens))
    assert plog.dtype == torch.float32 and plog.shape == jlog.shape
    _close(plog.numpy(), jlog)
    for jseg, pseg in zip(jstate["segs"], pstate["segs"]):
        for jl, pl in zip(jseg, pseg):
            for key in pl:
                _leaf_close(key, pl[key], jl[key])


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma3-4b"])
def test_int8_paged_decode_matches_dense(arch):
    """Per-request paged prefill + decode reproduces the packed dense batch
    token for token in the model dtype, with int8 pools and cache."""
    cfg = dataclasses.replace(get_smoke_config(arch), kv_cache_dtype="int8")
    m = build_model(cfg)
    params = m.init(0, "cpu")
    rng = np.random.RandomState(0)
    b, ps, p_max = 2, 8, 4
    tb = rng.randint(1, cfg.vocab_size, (b, 11)).astype(np.int32)
    cache, _ = m.prefill(params, torch.from_numpy(tb[:, :-1]))
    cache = pad_cache(cache, p_max * ps)
    state = m.empty_paged_state(b, 1 + b * p_max, ps, device="cpu")
    assert state["segs"][0][0]["k"].dtype == torch.int8
    bt = np.zeros((b, p_max), np.int32)
    for i in range(b):
        npg = pages_per_request(10, 6, ps)
        bt[i, :npg] = np.arange(1 + i * npg, 1 + (i + 1) * npg)
        pc, _ = m.prefill(params, torch.from_numpy(tb[i:i + 1, :-1]))
        prefill_into_pages(state, pc, torch.from_numpy(bt[i, :2]), i, ps)
    last_d = last_p = torch.from_numpy(tb[:, -1:])
    lens = torch.tensor([10, 10], dtype=torch.int32)
    for _ in range(6):
        cache, ld = m.decode_step(params, cache, last_d)
        _, lp = m.decode_step_paged(params, state, last_p,
                                    torch.from_numpy(bt), lens)
        nd = ld[:, :cfg.vocab_size].argmax(-1)
        npg_ = lp[:, :cfg.vocab_size].argmax(-1)
        assert torch.equal(nd, npg_)
        last_d = nd[:, None].to(torch.int32)
        last_p = npg_[:, None].to(torch.int32)
        lens = lens + 1


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("pos", ["ragged", "shared"])
def test_dense_multi_position_branch_matches_jax(pos, window):
    """The prewritten dense-cache branch with S > 1 positions (the int8
    verify's): query s of sequence b at position pos[b] + s attends to
    positions <= pos[b] + s, as ``verify_attention_jnp`` does."""
    cfg = dataclasses.replace(get_smoke_config("h2o-danube-3-4b"),
                              dtype=torch.float32)
    m = build_model(cfg)
    p = {k: v[0] for k, v in
         cast_tree(m.init(0, "cpu"))["segs"][0][0]["attn"].items()}
    rng = np.random.RandomState(6)
    b, t, s_q = 3, 24, 4
    kv = [rng.randn(b, t, cfg.n_kv_heads, cfg.hd).astype(np.float32)
          for _ in range(2)]
    x = rng.randn(b, s_q, cfg.d_model).astype(np.float32)
    p_np = {k: v.numpy() for k, v in p.items()}
    lens = (np.array([3, 11, 19], np.int32) if pos == "ragged" else 9)
    cache = {"k": torch.from_numpy(kv[0]), "v": torch.from_numpy(kv[1]),
             "pos": torch.as_tensor(lens)}
    out, new_kv = attention_block(cfg, p, torch.from_numpy(x), cache=cache,
                                  window=window, prewritten=True)
    assert new_kv is None and out.shape == (b, s_q, cfg.d_model)
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models.attention import attention_block as ref_block
    rc = dataclasses.replace(ref_smoke("h2o-danube-3-4b"), dtype=jnp.float32)
    want, _ = ref_block(rc, {k: jnp.asarray(v) for k, v in p_np.items()},
                        jnp.asarray(x), window=window, prewritten=True,
                        cache={"k": jnp.asarray(kv[0]),
                               "v": jnp.asarray(kv[1]),
                               "pos": jnp.asarray(lens)})
    _close(out.numpy(), want)
    # the core alone, on the same q
    from repro_torch.kernels.decode_attention import ops
    q = rng.randn(b, s_q, cfg.n_heads, cfg.hd).astype(np.float32)
    got = ops.verify_attention(torch.from_numpy(q), cache["k"], cache["v"],
                               torch.as_tensor(lens) + 1, window=window)
    ref = verify_attention_jnp(jnp.asarray(q), jnp.asarray(kv[0]),
                               jnp.asarray(kv[1]),
                               jnp.asarray(lens) + 1, window=window)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("window", [0, 5])
def test_dense_verify_row_is_decode_at_lens_plus_s(window):
    """``ops.verify_attention`` (one call over S positions, the dense-cache
    kernel's verify form on the card) against ``ops.decode_attention`` of
    each row at lens + s, on the CPU's plain versions: the property the
    kernel holds bit for bit (one split kernel, rows independent)."""
    from repro_torch.kernels.decode_attention import ops
    rng = np.random.RandomState(8)
    b, t, s_q, kh, g, d = 3, 40, 4, 2, 3, 16
    q = torch.from_numpy(rng.randn(b, s_q, kh * g, d).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.randn(b, t, kh, d).astype(np.float32))
              for _ in range(2))
    lens = torch.tensor([1, 17, t - s_q + 1], dtype=torch.int32)
    got = ops.verify_attention(q, kc, vc, lens, window=window)
    for s in range(s_q):
        want = ops.decode_attention(q[:, s:s + 1], kc, vc, lens + s,
                                    window=window)
        np.testing.assert_allclose(got[:, s:s + 1].numpy(), want.numpy(),
                                   rtol=0, atol=1e-6)


def test_int8_config_keeps_hymba_kv_in_the_model_dtype():
    """``kv_cache_dtype="int8"`` quantizes attention layers only, as the
    reference: hymba's K/V stay in the model dtype in the prefill cache,
    the dense cache and the page pools (no scales), and its prefill and
    paged decode match JAX's."""
    jm, jp, pm, pp = _pair("hymba-1.5b", seed=2)
    toks = np.random.RandomState(2).randint(
        1, jm.cfg.vocab_size, (1, 11)).astype(np.int32)
    jcache, jlog = jm.prefill(jp, jnp.asarray(toks))
    pcache, plog = pm.prefill(pp, torch.from_numpy(toks))
    _close(plog.numpy(), jlog, rel=1e-4)
    jstate = jm.empty_paged_state(1, 3, 8)
    pstate = pm.empty_paged_state(1, 3, 8, device="cpu")
    for trees in ((jcache, pcache), (jstate, pstate),
                  (jm.empty_cache(1, 16), pm.empty_cache(1, 16, device="cpu"))):
        for jseg, pseg in zip(trees[0]["segs"], trees[1]["segs"]):
            for jl, pl in zip(jseg, pseg):
                assert set(pl) == set(jl) == {"k", "v", "s", "conv"}
                for key in pl:
                    assert pl[key].dtype == torch.float32
                    assert str(jl[key].dtype) == "float32"
    ids = np.array([2, 1], np.int32)
    jstate = jax_pip(jstate, jcache, jnp.asarray(ids), 0, 8)
    prefill_into_pages(pstate, pcache, torch.from_numpy(ids), 0, 8)
    bt, lens = np.array([[2, 1]], np.int32), np.array([11], np.int32)
    last = np.array([[7]], np.int32)
    _, jlog = jm.decode_step_paged(jp, jstate, jnp.asarray(last),
                                   jnp.asarray(bt), jnp.asarray(lens))
    _, plog = pm.decode_step_paged(pp, pstate, torch.from_numpy(last),
                                   torch.from_numpy(bt),
                                   torch.from_numpy(lens))
    _close(plog.numpy(), jlog, rel=1e-4)
