"""The port's recurrent cores and blocks against the JAX package.

The same NumPy-seeded inputs go through the JAX function and its port:

- ``chunked_gla`` at s in {1, 7, 128, 129, 256, 300} (the gcd fallback at
  7, 129 and 300: chunks of 7, 1 and 4 positions), with and without
  ``initial_state``: outputs and final state within 1e-5 of the largest
  JAX value, and against the sequential oracle ``gla_ref`` of both
  packages; one bf16 case within 1e-2;
- ``gla_decode_step``, ``slstm_scan`` and ``causal_conv1d``, each with
  and without state;
- ``ssd_branch`` (prefill and one decode step), ``hymba_layer``,
  ``mlstm_block`` and ``slstm_block`` of the smoke configs, float32, on
  the JAX parameters of layer 0 carried over by
  ``convert.model_params_from_numpy``;
- a bf16 ``hymba_layer`` whose ``beta`` holds values bf16 cannot: JAX
  promotes ``bf16 * float32 0-d`` to float32, the port must widen
  explicitly; at least half of the outputs are then bit-identical to
  JAX's (the rest differ by bf16 roundings elsewhere in the layer, where
  XLA keeps excess precision);
- the premises of the bf16/float32 rules: the JAX package's own bf16
  xLSTM and hymba decode departs from its own full sequence beyond 5e-2
  (why ``chip_smoke.py`` holds bf16 to float32), the port's bf16 decode
  held to float32 as ``chip_smoke.py`` holds it, the JAX package's own
  float32 xLSTM decode at full width (depth cut to 12) departing beyond
  1e-3 on the stock weights and not at unit fan-in (why ``chip_smoke.py``
  rescales them), and the xLSTM smoke model's state amplifying a 1e-6
  relative perturbation past 1e-4 relative in four steps (why
  ``tests/test_torch_models.py`` has ``STATE_TOL``).

Tolerance, float32: max |port - JAX| <= tol * max(1, max |JAX|): both sum
float32 products in another order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import hymba_block as j_hymba  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models import xlstm_blocks as j_xlstm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common import cast_tree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import hymba_block, layers, ssm  # noqa: E402
from repro_torch.models import xlstm_blocks  # noqa: E402

B, H, DK, DV = 2, 3, 8, 5


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    bound = tol * max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(np.asarray(got) - want)))
    assert err <= bound, (err, bound)


def _gla_inputs(s, seed, with_state):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, s, H, DK).astype(np.float32)
    k = rng.randn(B, s, H, DK).astype(np.float32) / np.sqrt(DK)
    v = rng.randn(B, s, H, DV).astype(np.float32)
    # decays in (0, 1]: log_a = -softplus(.) in (-inf, 0)
    log_a = -np.log1p(np.exp(rng.randn(B, s, H))).astype(np.float32)
    st = (rng.randn(B, H, DK, DV).astype(np.float32) if with_state
          else None)
    return q, k, v, log_a, st


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 7, 128, 129, 256, 300])
def test_chunked_gla_matches_jax_and_the_oracle(s, with_state):
    q, k, v, la, st = _gla_inputs(s, seed=s, with_state=with_state)
    jo, jst = j_ssm.chunked_gla(_j(q), _j(k), _j(v), _j(la),
                                chunk=min(128, s), initial_state=_j(st))
    po, pst = ssm.chunked_gla(_t(q), _t(k), _t(v), _t(la),
                              chunk=min(128, s), initial_state=_t(st))
    assert po.dtype == torch.float32 and pst.dtype == torch.float32
    _close(po, jo, 1e-5)
    _close(pst, jst, 1e-5)
    ro, rst = ssm.gla_ref(_t(q), _t(k), _t(v), _t(la), _t(st))
    jro, jrst = j_ssm.gla_ref(_j(q), _j(k), _j(v), _j(la), _j(st))
    _close(ro, jro, 1e-5)
    _close(rst, jrst, 1e-5)
    _close(po, jro, 1e-5)
    _close(pst, jrst, 1e-5)


def test_chunked_gla_bf16_matches_jax():
    """bf16 q/k/v: the products widened to float32 as JAX's
    ``preferred_element_type``, the intra-chunk scores and the state
    operand rounded to bf16 where JAX rounds them."""
    q, k, v, la, st = _gla_inputs(300, seed=11, with_state=True)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    jo, jst = j_ssm.chunked_gla(*bf, _j(la), chunk=128,
                                initial_state=_j(st))
    pt = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    po, pst = ssm.chunked_gla(*pt, _t(la), chunk=128, initial_state=_t(st))
    assert po.dtype == torch.bfloat16 and pst.dtype == torch.float32
    _close(po, jo, 1e-2)
    _close(pst, jst, 1e-2)


@pytest.mark.parametrize("with_state", [False, True])
def test_gla_decode_step_matches_jax(with_state):
    q, k, v, la, st = _gla_inputs(1, seed=3, with_state=with_state)
    st = st if with_state else np.zeros((B, H, DK, DV), np.float32)
    jo, jst = j_ssm.gla_decode_step(_j(q[:, 0]), _j(k[:, 0]), _j(v[:, 0]),
                                    _j(la[:, 0]), _j(st))
    po, pst = ssm.gla_decode_step(_t(q[:, 0]), _t(k[:, 0]), _t(v[:, 0]),
                                  _t(la[:, 0]), _t(st))
    _close(po, jo, 1e-5)
    _close(pst, jst, 1e-5)
    # one decode step is the chunked form at s = 1
    co, cst = ssm.chunked_gla(_t(q), _t(k), _t(v), _t(la),
                              initial_state=_t(st))
    _close(po, co[:, 0].numpy(), 1e-6)
    _close(pst, cst.numpy(), 1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_jax(with_state):
    rng = np.random.RandomState(5)
    s, dh = 9, 6
    xg = rng.randn(B, s, 4, H, dh).astype(np.float32)
    rw = (rng.randn(4, H, dh, dh) / np.sqrt(dh)).astype(np.float32)
    st = None
    if with_state:
        st = (rng.randn(B, H, dh).astype(np.float32),
              rng.uniform(0.5, 2.0, (B, H, dh)).astype(np.float32),
              rng.randn(B, H, dh).astype(np.float32))
    jh, jst = j_ssm.slstm_scan(_j(xg), _j(rw),
                               None if st is None else tuple(map(_j, st)))
    ph, pst = ssm.slstm_scan(_t(xg), _t(rw),
                             None if st is None else tuple(map(_t, st)))
    assert tuple(ph.shape) == jh.shape == (B, s, H, dh)
    _close(ph, jh, 1e-5)
    for p, j in zip(pst, jst):
        _close(p, j, 1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.RandomState(6)
    x = rng.randn(B, 5, 7).astype(np.float32)
    w = rng.randn(4, 7).astype(np.float32)
    st = rng.randn(B, 3, 7).astype(np.float32) if with_state else None
    jy, jst = j_layers.causal_conv1d(_j(x), _j(w), _j(st))
    py, pst = layers.causal_conv1d(_t(x), _t(w), _t(st))
    _close(py, jy, 1e-6)
    assert tuple(pst.shape) == jst.shape == (B, 3, 7)
    _close(pst, jst, 0.0)


def _layer0(arch, block, dtype=jnp.float32, seed=0):
    """(JAX config, port config, JAX layer-0 params of ``block``, the same
    carried over to the port)."""
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    jc = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    pc = dataclasses.replace(get_smoke_config(arch), dtype=tdt)
    jp = jax_build(jc).init(jax.random.PRNGKey(seed))
    if dtype == jnp.float32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    pp = convert.model_params_from_numpy(
        pc, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp),
        "cpu")
    si, j = [(si, j) for si, seg in enumerate(jp["segs"])
             for j, lay in enumerate(seg) if block in lay][0]
    jl = jax.tree.map(lambda a: a[0], jp["segs"][si][j][block])

    def first(t):
        return ({k: first(v) for k, v in t.items()} if isinstance(t, dict)
                else t[0])

    return jc, pc, jl, first(pp["segs"][si][j][block])


def _x(cfg, s, seed):
    return np.random.RandomState(seed).randn(2, s, cfg.d_model).astype(
        np.float32)


def test_ssd_branch_matches_jax_prefill_and_decode():
    jc, pc, jl, pl = _layer0("hymba-1.5b", "hymba")
    x = _x(jc, 11, 1)
    jo, jst = j_hymba.ssd_branch(jc, jl["ssd"], _j(x))
    po, pst = hymba_block.ssd_branch(pc, pl["ssd"], _t(x))
    _close(po, jo, 1e-5)
    for key in ("s", "conv"):
        _close(pst[key], jst[key], 1e-5)
    x1 = _x(jc, 1, 2)
    jo, jst2 = j_hymba.ssd_branch(jc, jl["ssd"], _j(x1), state=jst)
    po, pst2 = hymba_block.ssd_branch(pc, pl["ssd"], _t(x1), state=pst)
    _close(po, jo, 1e-5)
    for key in ("s", "conv"):
        _close(pst2[key], jst2[key], 1e-5)


def test_hymba_layer_matches_jax():
    jc, pc, jl, pl = _layer0("hymba-1.5b", "hymba", seed=1)
    x = _x(jc, 21, 3)                       # past the smoke window of 16
    jo, (jkv, jst) = j_hymba.hymba_layer(jc, jl, _j(x), window=16)
    po, (pkv, pst) = hymba_block.hymba_layer(pc, pl, _t(x), window=16)
    _close(po, jo, 1e-5)
    for p, j in zip(pkv, jkv):
        _close(p, j, 1e-5)
    for key in ("s", "conv"):
        _close(pst[key], jst[key], 1e-5)


def test_hymba_layer_bf16_promotes_beta_as_jax():
    jc, pc, jl, pl = _layer0("hymba-1.5b", "hymba", dtype=jnp.bfloat16)
    assert pl["beta"].dtype == torch.float32
    assert pl["ssd"]["w_dt"].dtype == torch.float32
    assert pl["ssd"]["w_x"].dtype == torch.bfloat16
    beta = np.array([1 + 2 ** -8, 0.75 + 3 * 2 ** -10], np.float32)
    jl["beta"], pl["beta"] = jnp.asarray(beta), torch.from_numpy(beta)
    x = _x(jc, 13, 1)
    jo, _ = j_hymba.hymba_layer(jc, jl, jnp.asarray(x, jnp.bfloat16),
                                window=16)
    po, _ = hymba_block.hymba_layer(pc, pl, torch.from_numpy(x).to(
        torch.bfloat16), window=16)
    assert po.dtype == torch.bfloat16
    jo = np.asarray(jo.astype(jnp.float32))
    _close(po, jo, 1e-2)
    assert float((po.float().numpy() == jo).mean()) >= 0.5


@pytest.mark.parametrize("decode", [False, True])
def test_mlstm_block_matches_jax(decode):
    jc, pc, jl, pl = _layer0("xlstm-350m", "mlstm", seed=2)
    x = _x(jc, 10, 4)
    jo, jst = j_xlstm.mlstm_block(jc, jl, _j(x))
    po, pst = xlstm_blocks.mlstm_block(pc, pl, _t(x))
    if decode:
        x1 = _x(jc, 1, 5)
        jo, jst = j_xlstm.mlstm_block(jc, jl, _j(x1), state=jst)
        po, pst = xlstm_blocks.mlstm_block(pc, pl, _t(x1), state=pst)
    _close(po, jo, 1e-5)
    for key in ("s", "conv"):
        _close(pst[key], jst[key], 1e-5)


@pytest.mark.parametrize("decode", [False, True])
def test_slstm_block_matches_jax(decode):
    jc, pc, jl, pl = _layer0("xlstm-350m", "slstm", seed=3)
    x = _x(jc, 10, 6)
    jo, jst = j_xlstm.slstm_block(jc, jl, _j(x))
    po, pst = xlstm_blocks.slstm_block(pc, pl, _t(x))
    if decode:
        x1 = _x(jc, 1, 7)
        jo, jst = j_xlstm.slstm_block(jc, jl, _j(x1), state=jst)
        po, pst = xlstm_blocks.slstm_block(pc, pl, _t(x1), state=pst)
    _close(po, jo, 1e-5)
    for key in ("c", "n", "h"):
        _close(pst[key], jst[key], 1e-5)


def _decode_gaps(logits, prefill, decode_step, toks, n, steps):
    """Per decode step, max |decode - full| / max |full| at the same
    position after prefilling toks[:, :n]; returns (gaps, decode logits,
    full logits) with the logits as float32 NumPy (B, steps, V)."""
    full = np.asarray(logits(toks), np.float32)
    cache = prefill(toks[:, :n])
    dec = []
    for t in range(n, n + steps):
        cache, lg = decode_step(cache, toks[:, t:t + 1])
        dec.append(np.asarray(lg, np.float32))
    dec = np.stack(dec, 1)
    ref = full[:, n:n + steps]
    gaps = np.abs(dec - ref).max(axis=(0, 2)) / np.abs(ref).max(axis=(0, 2))
    return gaps, dec, ref


def test_bf16_xlstm_decode_departs_from_its_full_sequence_in_jax():
    """The premise of ``chip_smoke.py``'s bf16 rule for the recurrent
    families: in bf16 the JAX package's own xLSTM decode departs from its
    own full-sequence logits beyond ``FULL_LIMITS["bf16"]``'s 5e-2 (the
    chunked form rounds the intra-chunk scores and the state update's
    operand to bf16, the one-token step keeps float32)."""
    from repro.models.zoo import pad_cache as jax_pad
    jm = jax_build(jax_smoke("xlstm-350m"))
    jp = jm.init(jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.RandomState(0).randint(
        1, 512, (4, 70)).astype(np.int32))
    gaps, _, _ = _decode_gaps(
        lambda t: jm.logits(jp, t).astype(jnp.float32),
        lambda t: jax_pad(jm.prefill(jp, t)[0], 70),
        lambda c, t: jm.decode_step(jp, c, t), toks, 64, 5)
    assert gaps.max() > 5e-2, gaps


def test_bf16_hymba_decode_departs_from_its_full_sequence_in_jax():
    """As the xLSTM test above, for hymba: in bf16 the JAX package's own
    hymba decode departs from its own full-sequence logits beyond
    ``FULL_LIMITS["bf16"]``'s 5e-2 after a prompt of 200 (across the smoke
    config's window of 16; the SSD branch runs ``chunked_gla``)."""
    from repro.models.zoo import pad_cache as jax_pad
    jm = jax_build(jax_smoke("hymba-1.5b"))
    jp = jm.init(jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.RandomState(0).randint(
        1, 512, (4, 216)).astype(np.int32))
    gaps, _, _ = _decode_gaps(
        lambda t: jm.logits(jp, t).astype(jnp.float32),
        lambda t: jax_pad(jm.prefill(jp, t)[0], 216),
        lambda c, t: jm.decode_step(jp, c, t), toks, 200, 15)
    assert gaps.max() > 5e-2, gaps


# the leaves whose "scaled" init takes its fan-in from the head count, as
# chip_smoke.py's FAN_IN_LEAVES, by the key of the block that holds them
FAN_IN_LEAVES = {"mlstm": ("wq", "wk", "wv", "w_gates"), "slstm": ("w_in",)}


def _unit_fan_in(node, key=None):
    """A NumPy parameter tree with FAN_IN_LEAVES rescaled to the fan-in of
    the width they contract (shape[1] of the stacked leaf), as
    ``chip_smoke.py``'s ``_unit_fan_in``."""
    if isinstance(node, list):
        return [_unit_fan_in(v) for v in node]
    if not isinstance(node, dict):
        return node
    out = {k: _unit_fan_in(v, k) for k, v in node.items()}
    for name in FAN_IN_LEAVES.get(key, ()):
        w = node[name]
        out[name] = w * np.float32(np.sqrt(w.shape[-2] / w.shape[1]))
    return out


def test_stock_xlstm_float32_decode_departs_in_jax():
    """Why ``chip_smoke.py`` rescales xLSTM's projections before holding
    its float32 decode to ``FULL_LIMITS["float32"]``: at full width
    (xlstm-350m's d_model 1024, qk dim 256; depth cut to 12 layers, 10
    mLSTM and 2 sLSTM) and a prompt of 512, float32, the JAX package's own
    decode departs from its own full-sequence logits by more than 1e-3 of
    the largest logit on the stock weights (the "scaled" init takes the
    fan-in of the 3-D projections from the head count), and by less at
    unit fan-in; the port on the same weights does the same both ways."""
    from repro.configs import get_config as jax_config
    from repro.models.zoo import pad_cache as jax_pad
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.zoo import pad_cache
    n, steps = 512, 8
    jc = dataclasses.replace(jax_config("xlstm-350m"), n_layers=12,
                             dtype=jnp.float32)
    pc = dataclasses.replace(get_config("xlstm-350m"), n_layers=12,
                             dtype=torch.float32)
    jm, pm = jax_build(jc), build_model(pc)
    stock = jax.tree.map(lambda a: np.asarray(a, np.float32),
                         jm.init(jax.random.PRNGKey(0)))
    toks = np.random.RandomState(0).randint(
        1, jc.vocab_size, (1, n + steps)).astype(np.int32)
    j_logits, j_prefill, j_step = (jax.jit(jm.logits), jax.jit(jm.prefill),
                                   jax.jit(jm.decode_step))
    gaps = {}
    for name, tree in (("stock", stock), ("unit", _unit_fan_in(stock))):
        jp = jax.tree.map(jnp.asarray, tree)
        gaps["jax", name] = _decode_gaps(
            lambda t: j_logits(jp, t), lambda t: jax_pad(
                j_prefill(jp, t)[0], n + steps),
            lambda c, t: j_step(jp, c, t), jnp.asarray(toks), n,
            steps)[0].max()
        del jp
        pp = convert.model_params_from_numpy(pc, tree, "cpu")
        with torch.no_grad():
            gaps["port", name] = _decode_gaps(
                lambda t: pm.logits(pp, t),
                lambda t: pad_cache(pm.prefill(pp, t)[0], n + steps),
                lambda c, t: pm.decode_step(pp, c, t),
                torch.from_numpy(toks), n, steps)[0].max()
        del pp
    print(gaps)
    for pkg in ("jax", "port"):
        assert gaps[pkg, "stock"] > 1e-3 > gaps[pkg, "unit"], gaps


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_bf16_decode_held_to_float32_as_chip_smoke_holds_it(arch):
    """``chip_smoke.py``'s bf16 rule (``TRUTH_FACTOR``) on the smoke
    configs: the port's bf16 decode is no farther from the float32
    full-sequence logits of the same weights than twice the bf16 full
    sequence is, in max and in rms."""
    from repro_torch.models import build_model
    from repro_torch.models.zoo import pad_cache
    cfg = get_smoke_config(arch)
    m = build_model(cfg)
    m32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    p = m.init(0, "cpu")
    p32 = {"embed": p["embed"].float(), "final_norm": p["final_norm"].float(),
           "segs": [[{k: _to32(v) for k, v in lay.items()} for lay in seg]
                    for seg in p["segs"]]}
    if "out_embed" in p:
        p32["out_embed"] = p["out_embed"].float()
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        1, cfg.vocab_size, (4, 80)).astype(np.int32))
    n, steps = 64, 16
    _, dec, ref = _decode_gaps(
        lambda t: m.logits(p, t), lambda t: pad_cache(m.prefill(p, t)[0], 80),
        lambda c, t: m.decode_step(p, c, t), toks, n, steps)
    truth = m32.logits(p32, toks)[:, n:n + steps].numpy()

    def dist(x):
        d = x - truth
        return (np.abs(d).max() / np.abs(truth).max(),
                np.sqrt((d ** 2).mean() / (truth ** 2).mean()))

    d_dec, d_full = dist(dec), dist(ref)
    assert d_dec[0] <= 2 * d_full[0] and d_dec[1] <= 2 * d_full[1], (
        d_dec, d_full)


def _to32(tree):
    if isinstance(tree, dict):
        return {k: _to32(v) for k, v in tree.items()}
    return tree.float()


def test_xlstm_state_amplifies_float32_noise():
    """The premise of ``tests/test_torch_models.py``'s ``STATE_TOL``, on
    that test's model and tokens (the JAX xLSTM smoke parameters of seed 3
    in float32, 14 prompt tokens, four greedy decode steps): a relative
    perturbation of 1e-6 of the prefill state moves the sLSTM cell by
    more than 1e-4 of its largest value (a hundred times the perturbation),
    while the logits stay within 1e-3 relative."""
    from repro_torch.models import build_model
    from repro_torch.models.zoo import pad_cache
    jc = dataclasses.replace(jax_smoke("xlstm-350m"), dtype=jnp.float32)
    pc = dataclasses.replace(get_smoke_config("xlstm-350m"),
                             dtype=torch.float32)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_build(jc).init(jax.random.PRNGKey(3)))
    p = convert.model_params_from_numpy(pc, jax.tree.map(np.asarray, jp),
                                        "cpu")
    m = build_model(pc)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        1, pc.vocab_size, (2, 15)).astype(np.int32))
    caches = [pad_cache(m.prefill(p, toks[:, :-1])[0], 24) for _ in range(2)]
    gen = torch.Generator().manual_seed(0)
    for seg in caches[1]["segs"]:
        for lay in seg:
            for key, leaf in lay.items():
                if key != "conv":
                    leaf.mul_(1 + 1e-6 * torch.randn(leaf.shape,
                                                     generator=gen))
    last, logits = toks[:, -1:], [[], []]
    for _ in range(4):
        for i in range(2):
            caches[i], lg = m.decode_step(p, caches[i], last)
            logits[i].append(lg)
        last = logits[0][-1][:, :pc.vocab_size].argmax(-1)[:, None].to(
            torch.int32)
    cell = [c["segs"][-1][-1]["c"] for c in caches]
    assert float((cell[0] - cell[1]).abs().max()
                 / cell[0].abs().max()) > 1e-4
    a, b = (torch.stack(x) for x in logits)
    assert float((a - b).abs().max() / a.abs().max()) < 1e-3


# chip_smoke.py's L4 rule for the train step's weights: attention scores
# and the SSD heads' inputs of unit std
L4_FAN_IN = {"attn": ("wq", "wk"), "ssd": ("w_x", "w_z", "w_b", "w_c")}


def _l4_move(arch, rel=1e-6):
    """(loss move, worst gradient leaf's move) of one float32 microbatch of
    ``chip_smoke.py``'s L4 (smoke config, 2 x 64 tokens, L4's unit fan-in)
    when the embedding table, the stack's input, is perturbed by ``rel``
    relative; each move relative to the unperturbed value (a leaf's
    largest)."""
    import math

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.models import build_model
    from repro_torch.training import tree_leaves, tree_map

    def unit(node, key=None):
        if isinstance(node, list):
            return [unit(v) for v in node]
        if not isinstance(node, dict):
            return node
        out = {k: unit(v, k) for k, v in node.items()}
        for name in L4_FAN_IN.get(key, ()):
            w = node[name]
            out[name] = w * math.sqrt(w.shape[-2] / w.shape[1])
        return out

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    model = build_model(cfg)
    base = unit(cast_tree(model.init(0, "cpu")))
    raw = next(synthetic_batches(cfg, ShapeConfig("t", 64, 4, "train")))
    micro = {k: torch.from_numpy(v)[:2] for k, v in raw.items()}

    def loss_grads(params):
        live = tree_map(lambda t: t.detach().clone().requires_grad_(),
                        params)
        loss = model.loss(live, micro)
        return float(loss.detach()), torch.autograd.grad(loss,
                                                        tree_leaves(live))

    gen = torch.Generator().manual_seed(1)
    moved = dict(base, embed=base["embed"] * (
        1 + rel * torch.randn(base["embed"].shape, generator=gen)))
    (l0, g0), (l1, g1) = loss_grads(base), loss_grads(moved)
    g_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(g1, g0))
    return abs(l1 - l0) / abs(l0), g_rel


def test_hymba_gradients_amplify_float32_noise():
    """C13: the premise of ``chip_smoke.py``'s ``L4_TOL`` of 1e-4 for
    hymba-1.5b.  A relative perturbation of 1e-6 of the input moves
    hymba's gradients by >= 1e-5 of a leaf's largest value (measured
    8.7e-5), more than ten times a dense model's under the same
    perturbation (h2o-danube-3-4b, 3.2e-6, within L4's 1e-5).  Its loss,
    a mean over 128 tokens, moves by less than 1e-5 (less than a float32
    ulp here): so the wider limit is premised for the gradients only, and
    L4 holds the loss to 1e-5."""
    h_loss, h_grad = _l4_move("hymba-1.5b")
    d_loss, d_grad = _l4_move("h2o-danube-3-4b")
    assert h_grad >= 1e-5 and h_grad >= 10 * d_grad, (h_grad, d_grad)
    assert d_grad < 1e-5, d_grad
    assert h_loss < 1e-5 and d_loss < 1e-5, (h_loss, d_loss)
