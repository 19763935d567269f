"""The port's encoder-decoder LM against the JAX package.

seamless-m4t-large-v2's smoke config (2 encoder and 2 decoder layers, d 64,
4 heads) in float32 in both packages, the JAX parameters carried over by
``convert.model_params_from_numpy``, NumPy-seeded frame embeddings of 17
positions (the reference's stub frontend) and decoder prompts of 11
tokens (the two lengths differ on purpose):

- ``encode``, ``hidden`` and ``logits``;
- ``prefill``: the last position's logits and the cache (self-attention
  K/V ``(L, B, S_dec, K, D)``, encoder K/V ``ck``/``cv`` ``(L, B, S_enc,
  K, D)``);
- ``zoo.pad_cache`` then four greedy ``decode_step`` calls (logits every
  step, the greedy tokens, the cache after them), and within the port, the
  first step equal to the full sequence's last logits;
- ``pad_cache`` grows ``k``/``v`` and leaves ``ck``/``cv`` alone;
  ``empty_cache`` is shaped as JAX's; neither package has a paged state;
- the declarations have no ``out_embed`` (the reference's tree: the LM
  head is ``embed``);
- the cross-attention branches of ``attention_block`` (``kv_x`` on the
  full sequence, ``cross_cached`` in decode) on their own;
- refusals: the port's ``Endpoint`` (as the reference's) and
  ``RestartEndpoint`` refuse the family, and the reference's
  ``RestartEndpoint`` cannot admit a request of it (its re-prefill passes
  no frame embeddings).

Tolerance: max |port - JAX| <= 1e-4 * max(1, max |JAX|), as
``tests/test_torch_models.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.zoo import pad_cache as jax_pad  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import EncDecLM, build_model  # noqa: E402
from repro_torch.models.attention import attention_block  # noqa: E402
from repro_torch.models.zoo import pad_cache  # noqa: E402
from repro_torch.serving.engine import (Endpoint, Request,  # noqa: E402
                                        RestartEndpoint)

ARCH = "seamless-m4t-large-v2"
S_ENC, S_DEC = 17, 11


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    bound = tol * max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= bound, (err, bound)


@functools.lru_cache(maxsize=None)
def _pair():
    """(jax model, jax float32 params, port model, port params)."""
    jc = dataclasses.replace(jax_smoke(ARCH), dtype=jnp.float32)
    pc = dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32)
    jm = jax_build(jc)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    pm = build_model(pc)
    pp = convert.model_params_from_numpy(pc, jax.tree.map(np.asarray, jp),
                                         "cpu")
    return jm, jp, pm, pp


def _inputs(seed, b=2, s_dec=S_DEC):
    rng = np.random.RandomState(seed)
    cfg = _pair()[0].cfg
    toks = rng.randint(1, cfg.vocab_size, (b, s_dec)).astype(np.int32)
    emb = rng.randn(b, S_ENC, cfg.d_model).astype(np.float32)
    return toks, emb


def test_encode_hidden_and_logits_match_jax():
    jm, jp, pm, pp = _pair()
    assert isinstance(pm, EncDecLM)
    toks, emb = _inputs(0)
    je, pe = jnp.asarray(emb), torch.from_numpy(emb)
    mem = pm.encode(pp, pe)
    assert tuple(mem.shape) == (2, S_ENC, pm.cfg.d_model)
    _close(mem, jm.encode(jp, je))
    _close(pm.hidden(pp, torch.from_numpy(toks), pe),
           jm.hidden(jp, jnp.asarray(toks), je))
    got = pm.logits(pp, torch.from_numpy(toks), pe)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, S_DEC, pm.cfg.padded_vocab)
    _close(got, jm.logits(jp, jnp.asarray(toks), je))


def test_prefill_matches_jax():
    jm, jp, pm, pp = _pair()
    toks, emb = _inputs(1)
    jcache, jlog = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(emb))
    pcache, plog = pm.prefill(pp, torch.from_numpy(toks),
                              torch.from_numpy(emb))
    _close(plog, jlog)
    assert pcache["pos"] == int(jcache["pos"]) == S_DEC
    (layer,), (jlayer,) = pcache["segs"], jcache["segs"]
    assert set(layer[0]) == set(jlayer[0]) == {"k", "v", "ck", "cv"}
    cfg = pm.cfg
    for key, t in (("k", S_DEC), ("v", S_DEC), ("ck", S_ENC), ("cv", S_ENC)):
        assert tuple(layer[0][key].shape) == (
            cfg.n_layers, 2, t, cfg.n_kv_heads, cfg.hd)
        _close(layer[0][key], jlayer[0][key])


def test_decode_step_matches_jax():
    jm, jp, pm, pp = _pair()
    toks, emb = _inputs(2, s_dec=S_DEC + 1)
    je, pe = jnp.asarray(emb), torch.from_numpy(emb)
    full = pm.logits(pp, torch.from_numpy(toks), pe)
    jcache, _ = jm.prefill(jp, jnp.asarray(toks[:, :-1]), je)
    pcache, _ = pm.prefill(pp, torch.from_numpy(toks[:, :-1]), pe)
    jcache, pcache = jax_pad(jcache, 20), pad_cache(pcache, 20)
    last = toks[:, -1:]
    vocab = pm.cfg.vocab_size
    step = jax.jit(jm.decode_step)
    for i in range(4):
        jcache, jlog = step(jp, jcache, jnp.asarray(last))
        pcache, plog = pm.decode_step(pp, pcache, torch.from_numpy(last))
        assert plog.dtype == torch.float32
        _close(plog, jlog)
        if i == 0:      # the prompt's last token: the full sequence's
            _close(plog, full[:, -1].numpy())
        nxt = np.asarray(jlog)[:, :vocab].argmax(-1).astype(np.int32)
        assert np.array_equal(plog.numpy()[:, :vocab].argmax(-1), nxt)
        last = nxt[:, None]
    assert pcache["pos"] == int(jcache["pos"]) == S_DEC + 4
    for key in ("k", "v", "ck", "cv"):
        _close(pcache["segs"][0][0][key], jcache["segs"][0][0][key])


def test_pad_cache_grows_only_the_self_attention_kv():
    jm, jp, pm, pp = _pair()
    toks, emb = _inputs(3)
    cache, _ = pm.prefill(pp, torch.from_numpy(toks), torch.from_numpy(emb))
    grown = pad_cache(cache, 32)
    layer, new = cache["segs"][0][0], grown["segs"][0][0]
    assert new["k"].shape[2] == new["v"].shape[2] == 32
    assert torch.equal(new["k"][:, :, :S_DEC], layer["k"])
    assert not new["k"][:, :, S_DEC:].any()
    for key in ("ck", "cv"):
        assert new[key] is layer[key] and new[key].shape[2] == S_ENC
    jgrown = jax_pad(jm.prefill(jp, jnp.asarray(toks),
                                jnp.asarray(emb))[0], 32)
    assert {k: tuple(v.shape) for k, v in new.items()} == {
        k: v.shape for k, v in jgrown["segs"][0][0].items()}


def test_empty_cache_and_paged_state_as_jax():
    jm, _, pm, _ = _pair()
    for enc_len in (0, S_ENC):
        want = jm.empty_cache(3, 24, enc_len)
        got = pm.empty_cache(3, 24, enc_len, device="cpu")
        assert got["pos"] == 0
        assert {k: tuple(v.shape) for k, v in got["segs"][0][0].items()} \
            == {k: v.shape for k, v in want["segs"][0][0].items()}
        assert all(v.dtype == torch.float32
                   for v in got["segs"][0][0].values())
    with pytest.raises(NotImplementedError):
        jm.empty_paged_state(2, 5, 8)
    with pytest.raises(NotImplementedError):
        pm.empty_paged_state(2, 5, 8, device="cpu")


def test_decls_have_no_out_embed():
    """The reference's tree, leaf for leaf: no ``out_embed`` although the
    config does not tie the embeddings, so the LM head is ``embed``."""
    jm, jp, pm, pp = _pair()
    assert not pm.cfg.tie_embeddings
    assert "out_embed" not in pm.decls() and "out_embed" not in jp

    def paths(tree, prefix=()):
        if isinstance(tree, dict):
            return {p for k, v in tree.items()
                    for p in paths(v, prefix + (k,))}
        if isinstance(tree, (list, tuple)):
            return {p for i, v in enumerate(tree)
                    for p in paths(v, prefix + (i,))}
        return {prefix}

    assert paths(pm.decls()) == paths(jp)
    assert pm._out_table(pp) is pp["embed"]


@pytest.mark.parametrize("branch", ["kv_x", "cross_cached"])
def test_cross_attention_branches_match_jax(branch):
    """Layer 0's cross-attention weights: the query from 5 positions (1 in
    decode) against K/V projected from 17 source positions without RoPE
    (``kv_x``), or against K/V given as a cache (``cross_cached``)."""
    jm, jp, pm, pp = _pair()
    jw = jax.tree.map(lambda a: a[0], jp["segs"][0][0]["cross"])
    pw = {k: v[0] for k, v in pp["segs"][0][0]["cross"].items()}
    cfg = pm.cfg
    rng = np.random.RandomState(4)
    sq = 5 if branch == "kv_x" else 1
    x = rng.randn(2, sq, cfg.d_model).astype(np.float32)
    if branch == "kv_x":
        src = rng.randn(2, S_ENC, cfg.d_model).astype(np.float32)
        jkw = dict(kv_x=jnp.asarray(src))
        pkw = dict(kv_x=torch.from_numpy(src))
    else:
        kv = rng.randn(2, 2, S_ENC, cfg.n_kv_heads, cfg.hd).astype(np.float32)
        jkw = dict(cross_cached=True, cache={
            "k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]), "pos": 3})
        pkw = dict(cross_cached=True, cache={
            "k": torch.from_numpy(kv[0]), "v": torch.from_numpy(kv[1])})
    jy, jkv = j_attn.attention_block(jax_smoke(ARCH), jw, jnp.asarray(x),
                                     causal=False, use_rope=False, **jkw)
    py, pkv = attention_block(cfg, pw, torch.from_numpy(x), causal=False,
                              use_rope=False, **pkw)
    _close(py, jy)
    if branch == "kv_x":
        for got, want in zip(pkv, jkv):
            assert tuple(got.shape) == (2, S_ENC, cfg.n_kv_heads, cfg.hd)
            _close(got, want)
    else:
        assert pkv is None and jkv is None


def test_endpoints_refuse_the_encoder_decoder():
    """The port's ``Endpoint`` refuses the family with the reference's
    error, and its ``RestartEndpoint`` refuses it too."""
    pc = get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError) as port_err:
        Endpoint(pc, device="cpu")
    with pytest.raises(NotImplementedError) as jax_err:
        jax_engine.Endpoint(jax_smoke(ARCH))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(NotImplementedError):
        RestartEndpoint(pc, device="cpu")
    Request(0, np.ones(3, np.int32))        # the request itself is fine


def test_jax_restart_endpoint_cannot_admit_the_encoder_decoder():
    """Why the port refuses early: the reference's ``RestartEndpoint``
    builds, then fails at its first admission, whose re-prefill calls
    ``prefill(params, tokens)`` with no frame embeddings."""
    ep = jax_engine.RestartEndpoint(jax_smoke(ARCH), max_concurrency=2,
                                    t_max=8)
    req = jax_engine.Request(0, np.arange(1, 6, dtype=np.int32), max_new=2)
    with pytest.raises(AttributeError, match="astype"):
        # staticcheck: ignore[SC08] -- RestartEndpoint keeps no page pool
        # and no slot free lists; the failed admission built no cache
        ep.admit(req)
    assert ep._cache is None
