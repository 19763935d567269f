"""The port's decoder against the JAX package.

The smoke configs of h2o-danube-3-4b (sliding window), internlm2-20b,
qwen2-72b (``qkv_bias``), gemma3-4b (5:1 local:global, tied embeddings),
hymba-1.5b (attention in parallel with SSD heads in every layer, per-slot
SSD state beside the page pools), xlstm-350m (mLSTM and sLSTM blocks,
per-slot state only), dbrx-132b (a mixture-of-experts FFN in every layer)
and llama4-maverick-400b-a17b (a dense layer, then a MoE layer with a
shared expert), run in float32 in both packages with the JAX parameters
carried over by ``convert.model_params_from_numpy``:

- the full-sequence ``logits`` and ``prefill`` (last-position logits, the
  K/V cache and the recurrent state of every layer);
- six greedy steps of ``decode_step_paged`` over a shuffled block table
  with ragged lengths, after each request was prefilled alone and scattered
  into the pages by ``prefill_into_pages``: logits every step, and the
  greedy tokens equal;
- one ``verify_step_paged`` of four positions over the same paged state:
  the (B, S, V) float32 logits against JAX's, and, within the port,
  against four sequential ``decode_step_paged`` calls on a copy of the
  state (logits to the same tolerance, greedy tokens and the written pages
  equal); on a recurrent model both packages raise
  ``NotImplementedError``;
- the dense-cache path: ``prefill`` + ``zoo.pad_cache`` + four greedy
  ``decode_step`` calls against JAX's (logits every step, greedy tokens
  equal, the grown cache and ``empty_cache`` shaped as JAX's); within the
  port, ``decode_step`` after a prefill reproduces the full-sequence
  logits of the last token (``tests/test_models.py``'s
  ``test_decode_matches_full_forward``, same tolerance), and the dense
  decode and the paged decode give the same greedy tokens in the model
  dtype (``tests/test_serving_paged.py``'s
  ``test_paged_decode_matches_dense``, dbrx-132b among its cases);
- phi-3-vision-4.2b's patch-embedding prefix (``embeds`` before the
  tokens) through ``logits``, ``prefill`` and dense decode steps;
- the full-width declarations (parameter counts, plans) of every family,
  on no device.

Tolerance: max |port - JAX| <= 1e-4 * max(1, max |JAX|).  Both sum float32
products in another order; with random weights the activations reach ~20
and the differences grow with depth (measured up to 4e-5 relative on
gemma3's six layers).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.zoo import pad_cache as jax_pad  # noqa: E402
from repro.models.zoo import prefill_into_pages as jax_pip  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common import cast_tree  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import attention_block  # noqa: E402
from repro_torch.models.zoo import (pad_cache,  # noqa: E402
                                    pages_per_request, prefill_into_pages)

ARCHS = ["h2o-danube-3-4b", "internlm2-20b", "qwen2-72b", "gemma3-4b",
         "hymba-1.5b", "xlstm-350m", "dbrx-132b",
         "llama4-maverick-400b-a17b"]
RECURRENT = ("hymba-1.5b", "xlstm-350m")
TOL = {"xlstm-350m": 1e-3}
# the recurrent state after decode steps: the xLSTM stack amplifies float32
# noise (tests/test_torch_recurrent.py::test_xlstm_state_amplifies_float32
# _noise: on this model and these tokens a 1e-6 relative perturbation of
# the prefill state moves the sLSTM cell by more than 1e-4 of its largest
# value in four decode steps while the logits stay within 1e-3 relative)
STATE_TOL = {"xlstm-350m": 1e-2}


def _close(got, want, arch=None, tols=TOL):
    want = np.asarray(want)
    tol = tols.get(arch, 1e-4) * max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(np.asarray(got) - want)))
    assert err <= tol, (err, tol)


def _bucket(arch, plen, ps):
    """The engine's prefill length: a page multiple (attention pads are
    masked by lens), the exact length for a recurrent model."""
    return plen if arch in RECURRENT else -(-plen // ps) * ps


def _pair(arch, seed=0):
    """(jax model, jax float32 params, port model, port params)."""
    jc = dataclasses.replace(jax_smoke(arch), dtype=jnp.float32)
    pc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    jm = jax_build(jc)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(seed)))
    pm = build_model(pc)
    pp = convert.model_params_from_numpy(pc, jax.tree.map(np.asarray, jp),
                                         "cpu")
    return jm, jp, pm, pp


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_prefill_match_jax(arch):
    jm, jp, pm, pp = _pair(arch)
    toks = np.random.RandomState(0).randint(
        1, jm.cfg.vocab_size, (2, 20)).astype(np.int32)
    _close(pm.logits(pp, torch.from_numpy(toks)).numpy(),
           jm.logits(jp, jnp.asarray(toks)), arch)
    jcache, jlog = jm.prefill(jp, jnp.asarray(toks))
    pcache, plog = pm.prefill(pp, torch.from_numpy(toks))
    _close(plog.numpy(), jlog, arch)
    assert pcache["pos"] == 20
    assert len(pcache["segs"]) == len(jcache["segs"])
    for jseg, pseg in zip(jcache["segs"], pcache["segs"]):
        assert len(jseg) == len(pseg)
        for jl, pl in zip(jseg, pseg):
            assert set(pl) == set(jl)
            assert ("k" in pl) == (arch != "xlstm-350m")
            for key in jl:
                assert tuple(pl[key].shape) == jl[key].shape
                assert pl[key].dtype == torch.float32
                _close(pl[key].numpy(), jl[key], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_jax(arch):
    jm, jp, pm, pp = _pair(arch, seed=1)
    rng = np.random.RandomState(1)
    b, ps, p_max = 3, 8, 4
    n_pages = 1 + b * p_max
    plens = [5, 11, 16]
    jstate = jm.empty_paged_state(b, n_pages, ps)
    pstate = pm.empty_paged_state(b, n_pages, ps, device="cpu")
    bt = np.zeros((b, p_max), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    last = np.zeros((b, 1), np.int32)
    for i, plen in enumerate(plens):
        toks = rng.randint(1, jm.cfg.vocab_size, (plen + 1,)).astype(np.int32)
        n_used = pages_per_request(plen, 6, ps)
        bt[i, :n_used] = perm[i * p_max:i * p_max + n_used]
        bucket = _bucket(arch, plen, ps)
        pt = np.zeros((1, bucket), np.int32)
        pt[0, :plen] = toks[:-1]
        jcache, _ = jm.prefill(jp, jnp.asarray(pt))
        pcache, _ = pm.prefill(pp, torch.from_numpy(pt))
        ids = bt[i, :-(-bucket // ps)]
        jstate = jax_pip(jstate, jcache, jnp.asarray(ids), i, ps)
        prefill_into_pages(pstate, pcache, torch.from_numpy(ids), i, ps)
        last[i, 0] = toks[-1]
    for si, seg in enumerate(pstate["segs"]):    # the scatter, in place
        for j, layer in enumerate(seg):
            assert set(layer) == set(jstate["segs"][si][j])
            for key in layer:
                _close(layer[key].numpy(), jstate["segs"][si][j][key], arch)
    lens = np.asarray(plens, np.int32)
    step = jax.jit(jm.decode_step_paged)
    vocab = jm.cfg.vocab_size
    for _ in range(6):
        jstate, jlog = step(jp, jstate, jnp.asarray(last), jnp.asarray(bt),
                            jnp.asarray(lens))
        _, plog = pm.decode_step_paged(pp, pstate, torch.from_numpy(last),
                                       torch.from_numpy(bt),
                                       torch.from_numpy(lens))
        assert plog.dtype == torch.float32
        _close(plog.numpy(), jlog, arch)
        nxt = np.asarray(jlog)[:, :vocab].argmax(-1).astype(np.int32)
        assert np.array_equal(plog.numpy()[:, :vocab].argmax(-1), nxt)
        last, lens = nxt[:, None], lens + 1


def _paged_setup(arch, jm, jp, pm, pp, plens, s_extra, seed):
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
        bucket = _bucket(arch, plen, ps)
        pt = np.zeros((1, bucket), np.int32)
        pt[0, :plen] = toks[:-1]
        jcache, _ = jm.prefill(jp, jnp.asarray(pt))
        pcache, _ = pm.prefill(pp, torch.from_numpy(pt))
        ids = bt[i, :-(-bucket // ps)]
        jstate = jax_pip(jstate, jcache, jnp.asarray(ids), i, ps)
        prefill_into_pages(pstate, pcache, torch.from_numpy(ids), i, ps)
        last[i, 0] = toks[-1]
    return jstate, pstate, bt, np.asarray(plens, np.int32), last


def _clone_state(state):
    return {"segs": [[{k: v.clone() for k, v in layer.items()}
                      for layer in seg] for seg in state["segs"]]}


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_verify_matches_jax_and_sequential_decode(arch):
    jm, jp, pm, pp = _pair(arch, seed=2)
    s_q = 4
    jstate, pstate, bt, lens, last = _paged_setup(arch, jm, jp, pm, pp,
                                                  [5, 11, 16], s_q, seed=2)
    rng = np.random.RandomState(3)
    toks = np.concatenate([last, rng.randint(
        1, jm.cfg.vocab_size, (len(lens), s_q - 1)).astype(np.int32)], 1)
    if arch in RECURRENT:
        # recurrent state advances token by token: both packages refuse
        args = (jnp.asarray(toks), jnp.asarray(bt), jnp.asarray(lens))
        with pytest.raises(NotImplementedError):
            jax.jit(jm.verify_step_paged)(jp, jstate, *args)
        with pytest.raises(NotImplementedError):
            pm.verify_step_paged(pp, pstate, torch.from_numpy(toks),
                                 torch.from_numpy(bt),
                                 torch.from_numpy(lens))
        return
    seq_state = _clone_state(pstate)
    _, jlog = jax.jit(jm.verify_step_paged)(jp, jstate, jnp.asarray(toks),
                                            jnp.asarray(bt),
                                            jnp.asarray(lens))
    _, plog = pm.verify_step_paged(pp, pstate, torch.from_numpy(toks),
                                   torch.from_numpy(bt),
                                   torch.from_numpy(lens))
    assert plog.dtype == torch.float32 and plog.shape == jlog.shape
    _close(plog.numpy(), jlog)
    vocab = jm.cfg.vocab_size
    for j in range(s_q):
        _, dlog = pm.decode_step_paged(pp, seq_state,
                                       torch.from_numpy(toks[:, j:j + 1]),
                                       torch.from_numpy(bt),
                                       torch.from_numpy(lens + j))
        _close(plog[:, j].numpy(), dlog.numpy())
        assert torch.equal(plog[:, j, :vocab].argmax(-1),
                           dlog[:, :vocab].argmax(-1))
    for seg, seq_seg in zip(pstate["segs"], seq_state["segs"]):
        for layer, seq_layer in zip(seg, seq_seg):
            for key in ("k", "v"):
                _close(layer[key].numpy(), seq_layer[key].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_decode_step_matches_jax(arch):
    jm, jp, pm, pp = _pair(arch, seed=3)
    toks = np.random.RandomState(3).randint(
        1, jm.cfg.vocab_size, (2, 15)).astype(np.int32)
    jcache, _ = jm.prefill(jp, jnp.asarray(toks[:, :-1]))
    pcache, _ = pm.prefill(pp, torch.from_numpy(toks[:, :-1]))
    jcache, pcache = jax_pad(jcache, 24), pad_cache(pcache, 24)
    empty = pm.empty_cache(2, 24, device="cpu")
    assert empty["pos"] == 0 and pcache["pos"] == 14
    for jseg, pseg, eseg in zip(jcache["segs"], pcache["segs"],
                                empty["segs"]):
        for jl, pl, el in zip(jseg, pseg, eseg):
            assert set(pl) == set(jl) == set(el)
            for key in jl:
                assert tuple(pl[key].shape) == jl[key].shape \
                    == tuple(el[key].shape)
    last = toks[:, -1:]
    vocab = jm.cfg.vocab_size
    step = jax.jit(jm.decode_step)
    for _ in range(4):
        jcache, jlog = step(jp, jcache, jnp.asarray(last))
        pcache, plog = pm.decode_step(pp, pcache, torch.from_numpy(last))
        assert plog.dtype == torch.float32
        _close(plog.numpy(), jlog, arch)
        nxt = np.asarray(jlog)[:, :vocab].argmax(-1).astype(np.int32)
        assert np.array_equal(plog.numpy()[:, :vocab].argmax(-1), nxt)
        last = nxt[:, None]
    assert pcache["pos"] == int(jcache["pos"]) == 18
    for jseg, pseg in zip(jcache["segs"], pcache["segs"]):
        for jl, pl in zip(jseg, pseg):
            for key in jl:
                _close(pl[key].numpy(), jl[key], arch,
                       TOL if key in ("k", "v") else STATE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """prefill + decode_step reproduces the full-forward last-token logits
    (float32, to isolate logic from bf16 rounding)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    m = build_model(cfg)
    # the float32 config's bf16 init (the reference's) cast to float32
    params = cast_tree(m.init(0, "cpu"))
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        1, cfg.vocab_size, (2, 32)).astype(np.int32))
    full = m.logits(params, toks)
    cache, _ = m.prefill(params, toks[:, :-1])
    _, lgd = m.decode_step(params, pad_cache(cache, 32), toks[:, -1:])
    scale = float(full.abs().max())
    tol = TOL.get(arch, 1e-4)          # the recurrence accumulates
    assert float((lgd - full[:, -1]).abs().max()) / scale < tol


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma3-4b",
                                  "hymba-1.5b", "xlstm-350m", "dbrx-132b"])
def test_paged_decode_matches_dense(arch):
    """Per-request paged prefill + decode reproduces the packed dense batch
    token for token in the model dtype (equal prompt lengths, so the dense
    batch has no pads)."""
    cfg = get_smoke_config(arch)
    m = build_model(cfg)
    params = m.init(0, "cpu")
    rng = np.random.RandomState(0)
    b, ps, p_max = 2, 8, 4
    tb = rng.randint(1, cfg.vocab_size, (b, 11)).astype(np.int32)
    cache, _ = m.prefill(params, torch.from_numpy(tb[:, :-1]))
    cache = pad_cache(cache, p_max * ps)
    state = m.empty_paged_state(b, 1 + b * p_max, ps, device="cpu")
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


def test_prefix_embeds_match_jax():
    """phi-3-vision-4.2b's frontend: patch embeddings (float32, cast to the
    model dtype) before the tokens, through ``logits``, ``prefill`` (the
    cache covers both, ``pos`` counts both) and four dense decode steps."""
    arch = "phi-3-vision-4.2b"
    jm, jp, pm, pp = _pair(arch, seed=5)
    rng = np.random.RandomState(5)
    toks = rng.randint(1, jm.cfg.vocab_size, (2, 13)).astype(np.int32)
    emb = rng.randn(2, 6, jm.cfg.d_model).astype(np.float32)
    je, pe = jnp.asarray(emb), torch.from_numpy(emb)
    full = pm.logits(pp, torch.from_numpy(toks), pe)
    assert tuple(full.shape) == (2, 19, pm.cfg.padded_vocab)
    _close(full.numpy(), jm.logits(jp, jnp.asarray(toks), je), arch)
    jcache, jlog = jm.prefill(jp, jnp.asarray(toks[:, :-1]), je)
    pcache, plog = pm.prefill(pp, torch.from_numpy(toks[:, :-1]), pe)
    _close(plog.numpy(), jlog, arch)
    assert pcache["pos"] == int(jcache["pos"]) == 18
    jcache, pcache = jax_pad(jcache, 24), pad_cache(pcache, 24)
    for jl, pl in zip(jcache["segs"][0], pcache["segs"][0]):
        for key in jl:
            _close(pl[key].numpy(), jl[key], arch)
    last = toks[:, -1:]
    vocab = jm.cfg.vocab_size
    for _ in range(4):
        jcache, jlog = jm.decode_step(jp, jcache, jnp.asarray(last))
        pcache, plog = pm.decode_step(pp, pcache, torch.from_numpy(last))
        _close(plog.numpy(), jlog, arch)
        if _ == 0:     # the step after the prompt: the full forward's last
            _close(plog.numpy(), full[:, -1].numpy(), arch)
        last = np.asarray(jlog)[:, :vocab].argmax(-1).astype(np.int32)[:, None]
        assert np.array_equal(plog.numpy()[:, :vocab].argmax(-1), last[:, 0])


@pytest.mark.parametrize("arch,n_params,plan", [
    # 40 MoE layers of 16 experts (d 6,144, ff 10,752)
    ("dbrx-132b", 131_596_523_520, [(40, (("attn", True),))]),
    # 24 periods of (dense layer at dense_d_ff 16,384, MoE layer of 128
    # experts + one shared)
    ("llama4-maverick-400b-a17b", 400_713_815_040,
     [(24, (("attn", False), ("attn", True)))]),
    # 24 encoder and 24 decoder layers, d 1,024, no separate LM head
    ("seamless-m4t-large-v2", 1_772_480_512, [(24, (("xdec", False),))]),
])
def test_full_width_moe_and_encdec_declare_their_published_shapes(
        arch, n_params, plan):
    """dbrx-132b, llama4-maverick-400b-a17b and seamless-m4t-large-v2 at
    full width (declarations only, nothing allocated): the parameter
    counts of the reference's declarations and the layer plans."""
    cfg = get_config(arch)
    m = build_model(cfg)
    decls = m.decls()
    assert sum(int(np.prod(d.shape)) for d in _leaves(decls)) == n_params
    assert [(c, tuple((k.block, k.is_moe) for k in p))
            for c, p in m.plan] == plan
    if arch == "seamless-m4t-large-v2":
        assert [(c, [k.block for k in p]) for c, p in m.enc_plan] == [
            (24, ["enc"])]
        assert "out_embed" not in decls
        with pytest.raises(NotImplementedError):
            m.empty_paged_state(1, 1, 1, device="meta")
    else:
        state = m.empty_paged_state(1, 1, 1, device="meta")
        per_token = sum(t.numel() * t.element_size() for t in _leaves(state))
        assert per_token == 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2


def test_init_draws_the_config_dtype_and_the_reference_scales():
    """Random init on the target device's generator: the config's dtype,
    one seed -> one tree, and the reference's std rules (normal 0.02;
    "scaled" 1/sqrt(shape[-2]); ones; zeros)."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-72b"), d_model=128,
                              d_ff=256, vocab_size=2048)
    m = build_model(cfg)
    a, b = m.init(3, "cpu"), m.init(3, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], m.init(4, "cpu")["embed"])
    assert a["embed"].dtype == torch.bfloat16
    assert abs(float(a["embed"].float().std()) - 0.02) < 1e-3
    attn = a["segs"][0][0]["attn"]
    assert tuple(attn["wq"].shape) == (3, 128, 4, 32)
    assert abs(float(attn["wq"].float().std()) - 4 ** -0.5) < 0.02
    ffn = a["segs"][0][0]["ffn"]
    assert abs(float(ffn["w_down"].float().std()) - 256 ** -0.5) < 2e-3
    assert bool((a["final_norm"] == 1).all())
    assert bool((attn["bq"] == 0).all())


def test_full_width_danube_declares_its_published_shapes():
    """h2o-danube-3-4b at full width (declarations and a state on the meta
    device, nothing allocated): ~3.96 B parameters in bf16, 92,160 bytes of
    KV per token."""
    cfg = get_config("h2o-danube-3-4b")
    m = build_model(cfg)
    decls = _leaves(m.decls())
    assert 3.9e9 < sum(int(np.prod(d.shape)) for d in decls) < 4.0e9
    assert all(d.dtype == torch.bfloat16 for d in decls)
    state = m.empty_paged_state(1, 1, 1, device="meta")
    per_token = sum(t.numel() * t.element_size() for t in _leaves(state))
    assert per_token == 92_160
    assert [len(p) for _, p in m.plan] == [1]
    assert m.plan[0][0] == 24 and m.plan[0][1][0].window == 4096


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# the decode branch that writes its own K/V column: no caller of the
# reference reaches it (every decode path writes first, ``prewritten``)
@pytest.mark.parametrize("kwargs", [pytest.param(dict(cache={}),
                                                 id="kwargs1")])
def test_unported_attention_branches_raise(kwargs):
    cfg = dataclasses.replace(get_smoke_config("h2o-danube-3-4b"),
                              dtype=torch.float32)
    m = build_model(cfg)
    p = cast_tree(m.init(0, "cpu"))["segs"][0][0]["attn"]
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(NotImplementedError):
        attention_block(cfg, {k: v[0] for k, v in p.items()}, x, **kwargs)


@pytest.mark.parametrize("arch", [None, "hymba-1.5b", "xlstm-350m"])
def test_reset_slot_zeroes_only_per_slot_state(arch):
    """``reset_slot`` zeroes a slot's recurrent leaves in place and leaves
    the page pools alone (``lens`` masking covers stale KV): on a
    hand-made state, and on the paged state of a recurrent model."""
    from repro_torch.models.zoo import reset_slot
    if arch is None:
        pool = torch.ones(2, 5, 4, 1, 2)
        rec = torch.ones(2, 3, 6)
        state = {"segs": [[{"k": pool, "v": pool.clone(), "s": rec}]]}
    else:
        m = build_model(get_smoke_config(arch))
        state = m.empty_paged_state(3, 5, 4, device="cpu")
        for layer in _leaves(state):
            layer.fill_(1)
    assert reset_slot(state, 1) is state
    n_rec = 0
    for seg in state["segs"]:
        for layer in seg:
            for key, leaf in layer.items():
                if key in ("k", "v"):
                    assert bool((leaf == 1).all())
                else:
                    n_rec += 1
                    assert bool((leaf[:, 1] == 0).all())
                    assert bool((leaf[:, [0, 2]] == 1).all())
    assert n_rec > 0


def test_float32_declared_leaves_stay_float32_in_bf16():
    """The reference declares hymba's w_dt, dt_bias, a_log, d_skip and
    beta and the mLSTM's w_gates float32 in every model dtype: the port
    declares, draws and converts them so; every other leaf is bf16."""
    want = {"hymba-1.5b": {"w_dt", "dt_bias", "a_log", "d_skip", "beta"},
            "xlstm-350m": {"w_gates"}}
    for arch, f32_keys in want.items():
        cfg = get_smoke_config(arch)
        assert cfg.dtype == torch.bfloat16
        jc = jax_smoke(arch)
        jp = jax_build(jc).init(jax.random.PRNGKey(0))
        pp = convert.model_params_from_numpy(
            cfg, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                              jp), "cpu")
        drawn = build_model(cfg).init(0, "cpu")
        seen = set()
        for path, leaf in _paths(pp):
            name = path[-1]
            want = torch.float32 if name in f32_keys else torch.bfloat16
            assert leaf.dtype == _at(drawn, path).dtype == want, (arch, path)
            assert str(_at(jp, path).dtype) == str(want)[len("torch."):]
            if name in f32_keys:
                seen.add(name)
        assert seen == f32_keys
        # carried over exactly: bf16 values pass through float32
        path = next(p for p, _ in _paths(pp) if p[-1] in ("w_up", "w_x"))
        assert np.array_equal(_at(pp, path).float().numpy(),
                              np.asarray(_at(jp, path).astype(jnp.float32)))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch,n_params,slot_bytes,plan", [
    # 32 hymba layers: 10 windowed at 1024 then one global, twice, then 10
    # windowed; 25 x 16 x 64 float32 SSD state and a 3 x 1600 bf16
    # convolution tail a layer
    ("hymba-1.5b", (1.35e9, 1.36e9), 32 * (25 * 16 * 64 * 4 + 3 * 1600 * 2),
     [(2, 11), (1, 10)]),
    # 20 mLSTM (4 x 256 x 513 float32 memory, a 3 x 2048 bf16 tail) and 4
    # sLSTM (three 4 x 256 float32 vectors) layers
    ("xlstm-350m", (3.9e8, 4.0e8),
     20 * (4 * 256 * 513 * 4 + 3 * 2048 * 2) + 4 * 3 * 1024 * 4,
     [(4, 6)]),
])
def test_full_width_recurrent_declares_their_published_shapes(
        arch, n_params, slot_bytes, plan):
    """hymba-1.5b and xlstm-350m at full width (declarations and a state on
    the meta device): parameter counts, the per-slot recurrent state, the
    layer plans (hymba's layers 10 and 21 global, one sLSTM per six)."""
    cfg = get_config(arch)
    m = build_model(cfg)
    n = sum(int(np.prod(d.shape)) for d in _leaves(m.decls()))
    assert n_params[0] < n < n_params[1]
    state = m.empty_paged_state(1, 1, 1, device="meta")
    per_slot = sum(t.numel() * t.element_size()
                   for seg in state["segs"] for layer in seg
                   for key, t in layer.items() if key not in ("k", "v"))
    assert per_slot == slot_bytes
    assert [(c, len(p)) for c, p in m.plan] == plan
    kinds = [k for c, p in m.plan for _ in range(c) for k in p]
    if arch == "hymba-1.5b":
        assert [i for i, k in enumerate(kinds) if k.window == 0] == [10, 21]
        assert {k.window for k in kinds} == {0, 1024}
        assert cfg.hd == 64 and cfg.n_heads // cfg.n_kv_heads == 5
    else:
        assert [i for i, k in enumerate(kinds) if k.block == "slstm"] == [
            5, 11, 17, 23]
