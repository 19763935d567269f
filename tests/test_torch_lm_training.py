"""The port's language-model training path against the JAX package.

- ``layers.chunked_softmax_xent`` against the reference's, with vocabulary
  padding (the table padded past ``vocab_size``) and a token mask;
- ``loss`` of all ten smoke configs in float32 on the reference's own
  synthetic batches, parameters carried over by
  ``convert.model_params_from_numpy``: |port - JAX| <= 1e-5 * max(1,
  |JAX|);
- the gradient of ``loss`` against ``jax.grad`` on one config per family
  (dense, local:global, patch-embedding frontend, hybrid SSM, xLSTM, MoE,
  encoder-decoder): every leaf within 1e-5 of the tree's largest gradient.
  The init is rescaled to unit fan-in (``_unit_fan_in``, ``chip_smoke.py``'s
  rule): under the stock init attention scores reach std ~240, the softmax
  is nearly an argmax, and a float32 rounding moves a gradient by up to
  1.6e-4 of the largest (h2o-danube-3-4b).  xlstm-350m is held to 1e-4:
  its stack amplifies float32 noise (``tests/test_torch_models.py`` holds
  its logits to 1e-3), measured 4.6e-5;
- three ``Trainer.train_step``s against JAX's on h2o-danube-3-4b's smoke
  config, two microbatches, fp32, bf16 and int8 moments, the state carried
  by ``convert.train_state_from_numpy``, with q and k rescaled to unit-std
  scores (``_unit_fan_in``) so the float32 trajectory is well conditioned:
  loss and grad norm within 1e-5 relative, parameters within 1e-5 (fp32
  and bf16); int8 moments quantize a few elements across a rounding
  boundary, and AdamW turns a second moment that quantizes to 0 into an
  update of lr * m / eps, so there 99% of the parameters are held to 1e-5
  (measured 99.76%);
- remat "full" giving the loss and gradients of "none" bit for bit;
- ``synthetic_batches`` equal to the reference's for every family, and the
  ``Prefetcher`` on the CPU;
- the AdamW update in slices (``optim.SLICE_ELEMS`` lowered) equal to the
  whole-leaf update bit for bit in every moment dtype;
- ``train_state_to_numpy`` / ``train_state_from_numpy`` round trips;
- the launcher's ``--smoke --device cpu`` run in-process.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.data.pipeline import synthetic_batches as jax_batches  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.layers import chunked_softmax_xent as jax_xent  # noqa: E402
from repro.training import Trainer as JaxTrainer  # noqa: E402
from repro.training.optim import QTensor as JaxQTensor  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.data.pipeline import (Prefetcher,  # noqa: E402
                                       synthetic_batches)
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import chunked_softmax_xent  # noqa: E402
from repro_torch.training import (AdamW, QTensor, Trainer,  # noqa: E402
                                  optim, tree_leaves, tree_map)

FAMILIES = ["h2o-danube-3-4b", "gemma3-4b", "phi-3-vision-4.2b",
            "hymba-1.5b", "xlstm-350m", "dbrx-132b", "seamless-m4t-large-v2"]
GRAD_TOL = {"xlstm-350m": 1e-4}


def _pair(arch, seed=0, unit=False):
    """(jax model, jax float32 params, port model, port params); ``unit``
    rescales the init (``_unit_fan_in``)."""
    jc = dataclasses.replace(jax_smoke(arch), dtype=jnp.float32)
    pc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    jm = jax_build(jc)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      jm.init(jax.random.PRNGKey(seed)))
    jp = jax.tree.map(jnp.asarray, _unit_fan_in(jp) if unit else jp)
    pm = build_model(pc)
    pp = convert.model_params_from_numpy(pc, jax.tree.map(np.asarray, jp),
                                         "cpu")
    return jm, jp, pm, pp


def _batch(jm, seq=32, batch=2, seed=0):
    """The reference's synthetic batch as numpy, JAX and torch."""
    b = next(jax_batches(jm.cfg, JaxShape("t", seq, batch, "train"),
                         seed=seed))
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("padded,masked", [(False, False), (True, False),
                                           (True, True)])
def test_chunked_xent_matches_jax(padded, masked):
    rng = np.random.RandomState(int(padded) + 2 * int(masked))
    b, s, d, vocab = 3, 8, 16, 50
    rows = vocab + (14 if padded else 0)
    table = rng.randn(rows, d).astype(np.float32)
    hidden = rng.randn(b, s, d).astype(np.float32)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.rand(b, s) > 0.3) if masked else np.ones((b, s), bool)
    want = float(jax_xent(jnp.asarray(table), jnp.asarray(hidden),
                          jnp.asarray(labels), jnp.asarray(mask), vocab, 8))
    got = chunked_softmax_xent(torch.from_numpy(table),
                               torch.from_numpy(hidden),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask), vocab, 8)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))
    with pytest.raises(AssertionError, match="divisible"):
        chunked_softmax_xent(torch.from_numpy(table),
                             torch.from_numpy(hidden),
                             torch.from_numpy(labels),
                             torch.from_numpy(mask), vocab, 5)


@pytest.mark.parametrize("arch", list_archs())
def test_loss_matches_jax(arch):
    jm, jp, pm, pp = _pair(arch)
    jb, pb = _batch(jm)
    want = float(jm.loss(jp, jb))
    got = pm.loss(pp, pb)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * max(1.0, abs(want)), (
        float(got), want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_gradients_match_jax(arch):
    jm, jp, pm, pp = _pair(arch, unit=True)
    jb, pb = _batch(jm)
    want = [np.asarray(g) for g in jax.tree.leaves(jax.grad(jm.loss)(jp, jb))]
    live = tree_map(lambda t: t.detach().requires_grad_(), pp)
    got = torch.autograd.grad(pm.loss(live, pb), tree_leaves(live))
    assert len(got) == len(want)
    scale = max(float(np.max(np.abs(w))) for w in want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert float(np.max(np.abs(g.numpy() - w))) <= GRAD_TOL.get(
            arch, 1e-5) * scale


# chip_smoke.py's rule: the leaves whose init takes its fan-in from a
# head count, rescaled to the contracted width
FAN_IN_LEAVES = {"attn": ("wq", "wk"), "cross": ("wq", "wk"),
                 "ssd": ("w_x", "w_z", "w_b", "w_c"),
                 "mlstm": ("wq", "wk", "wv", "w_gates"), "slstm": ("w_in",)}


def _unit_fan_in(tree):
    """A NumPy parameter tree with the FAN_IN_LEAVES rescaled from the
    init's fan-in to the contracted width (shape[1] of the stacked leaf):
    attention scores, the SSD heads' and the xLSTM gates' inputs of unit
    std, so float32 roundings stay float32-sized through the stack."""
    def walk(node, key=None):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, k) for k, v in node.items()}
        for name in FAN_IN_LEAVES.get(key, ()):
            w = node[name]
            out[name] = w * np.float32(math.sqrt(w.shape[-2] / w.shape[1]))
        return out
    return walk(tree)


def _within(got, want, tol):
    return float(np.mean(np.abs(got - want) <= tol))


@pytest.mark.parametrize("moments", ["fp32", "bf16", "int8"])
def test_train_steps_match_jax(moments):
    arch = "h2o-danube-3-4b"
    jc = dataclasses.replace(jax_smoke(arch), dtype=jnp.float32)
    pc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    kw = dict(microbatches=2, moment_dtype=moments, accum_dtype="fp32")
    jt = JaxTrainer(jax_build(jc), JaxTrainConfig(**kw))
    pt = Trainer(build_model(pc), TrainConfig(**kw))
    _, jp, _, _ = _pair(arch, unit=True)
    js = {"params": jp, "opt": jt.opt.init(jp)}
    ps = convert.train_state_from_numpy(pc, pt.tcfg,
                                        jax.tree.map(np.asarray, js), "cpu")
    data = jax_batches(jc, JaxShape("t", 32, 4, "train"))
    for _ in range(3):
        b = next(data)
        js, jm = jax.jit(jt.train_step)(
            js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pt.train_step(ps, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        for key in ("loss", "grad_norm"):
            assert abs(float(pm[key]) - float(jm[key])) <= 1e-5 * abs(
                float(jm[key])), key
    assert ps["opt"]["step"] == int(js["opt"]["step"]) == 3
    back = convert.train_state_to_numpy(ps)
    for g, w in zip(tree_leaves(back["params"]),
                    jax.tree.leaves(jax.tree.map(np.asarray, js["params"]))):
        share = _within(g, w, 1e-5)
        assert share >= (0.99 if moments == "int8" else 1.0), share


def test_remat_full_equals_none():
    """Layer rematerialization changes what autograd keeps, not a value."""
    jm, _, pm, pp = _pair("h2o-danube-3-4b")
    _, pb = _batch(jm)
    out = {}
    for remat in ("none", "full"):
        model = build_model(dataclasses.replace(pm.cfg, remat=remat))
        live = tree_map(lambda t: t.detach().requires_grad_(), pp)
        loss = model.loss(live, pb)
        out[remat] = (loss, torch.autograd.grad(loss, tree_leaves(live)))
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list_archs())
def test_synthetic_batches_match_the_reference(arch):
    shape = ShapeConfig("t", 48, 3, "train")
    mine = synthetic_batches(get_smoke_config(arch), shape, seed=4)
    ref = jax_batches(jax_smoke(arch), JaxShape("t", 48, 3, "train"), seed=4)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key])


def test_prefetcher_on_the_cpu_keeps_order_and_stops():
    cfg = get_smoke_config("phi-3-vision-4.2b")
    shape = ShapeConfig("t", 32, 2, "train")
    pre = Prefetcher(synthetic_batches(cfg, shape), "cpu", depth=2)
    want = synthetic_batches(cfg, shape)
    for _ in range(4):
        got, ref = next(pre), next(want)
        for key in ref:
            assert got[key].device.type == "cpu"
            assert np.array_equal(got[key].numpy(), ref[key])
    pre.close()
    assert not pre.t.is_alive()


@pytest.mark.parametrize("moments", ["fp32", "bf16", "int8"])
def test_sliced_update_equals_whole_leaves(moments, monkeypatch):
    """Leaves above ``optim.SLICE_ELEMS`` go in slices along their leading
    axis: the same parameters and moments bit for bit."""
    gen = torch.Generator().manual_seed(7)

    def tree():
        return {"w": torch.randn(6, 20, 30, generator=gen),
                "e": torch.randn(50, 30, generator=gen),
                "n": torch.randn(30, generator=gen)}

    opt = AdamW(TrainConfig(moment_dtype=moments, grad_clip=0.5))
    p0 = tree()
    runs = []
    for limit in (1 << 30, 700):
        monkeypatch.setattr(optim, "SLICE_ELEMS", limit)
        assert len(optim._slices(p0["w"], limit)) == (1 if limit > 700
                                                      else 6)
        params = tree_map(lambda t: t.clone(), p0)
        state = opt.init(params)
        g2 = torch.Generator().manual_seed(8)
        norms = []
        for _ in range(3):
            grads = tree_map(lambda t: torch.randn(t.shape, generator=g2),
                             p0)
            norms.append(opt.update(grads, state, params))
        runs.append((params, state, norms))
    (pa, sa, na), (pb, sb, nb) = runs
    for a, b in zip(tree_leaves([pa, sa["m"], sa["v"], na]),
                    tree_leaves([pb, sb["m"], sb["v"], nb])):
        if isinstance(a, QTensor):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("moments", ["fp32", "bf16", "int8"])
def test_train_state_round_trip(moments):
    """A JAX Trainer state (bf16 parameters, moments in each dtype, after a
    step) -> the port -> NumPy gives the same values."""
    arch = "h2o-danube-3-4b"
    jc = jax_smoke(arch)
    kw = dict(microbatches=1, moment_dtype=moments)
    jt = JaxTrainer(jax_build(jc), JaxTrainConfig(**kw))
    js = jt.init_state(jax.random.PRNGKey(1))
    b = next(jax_batches(jc, JaxShape("t", 16, 2, "train")))
    js, _ = jax.jit(jt.train_step)(js, {k: jnp.asarray(v)
                                        for k, v in b.items()})
    pc = get_smoke_config(arch)
    ps = convert.train_state_from_numpy(pc, TrainConfig(**kw),
                                        jax.tree.map(np.asarray, js), "cpu")
    assert ps["opt"]["step"] == 1
    leaf = tree_leaves(ps["opt"]["m"])[0]
    if moments == "int8":
        assert isinstance(leaf, QTensor) and leaf.q.dtype == torch.int8
    else:
        assert leaf.dtype == (torch.bfloat16 if moments == "bf16"
                              else torch.float32)
    back = convert.train_state_to_numpy(ps)

    def flat(tree):
        return jax.tree.leaves(jax.tree.map(
            lambda x: np.asarray(x, np.float32), tree))

    want = jax.tree.map(np.asarray, js)
    if moments == "int8":
        for key in ("m", "v"):
            back["opt"][key] = tree_map(
                lambda t: JaxQTensor(q=t.q, scale=t.scale)
                if isinstance(t, QTensor) else t, back["opt"][key])
    for a, b in zip(flat(back), flat(want)):
        assert np.array_equal(a, b)


def test_launcher_smoke_run_on_the_cpu(tmp_path, capsys):
    last = launcher.main(["--arch", "gemma3-4b", "--smoke", "--steps", "3",
                          "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 0: loss" in out and "step 2: loss" in out
    assert "done: 3 steps" in out
    assert set(last) == {"loss", "grad_norm"}
    assert math.isfinite(last["loss"]) and math.isfinite(last["grad_norm"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000002.json", "ckpt_00000002.npz", "ckpt_00000003.json",
        "ckpt_00000003.npz"]


C11_DEPTHS = (2, 8, 24)


def _f32_draws(decls):
    """The declarations with every leaf float32: the stock init's draws
    unrounded (a float32 configuration's own init rounds them to bf16, as
    the reference's does)."""
    if isinstance(decls, dict):
        return {k: _f32_draws(v) for k, v in decls.items()}
    if isinstance(decls, list):
        return [_f32_draws(v) for v in decls]
    return dataclasses.replace(decls, dtype=torch.float32)


def _c11_norms(layers, seq=16):
    """The grad norm of one ``Trainer.train_step`` at d 512 and ``layers``
    layers (h2o-danube-3-4b's smoke config widened, float32, batch 1), the
    port's stock init (its float32 draws, seed 0) carried to JAX: (JAX's,
    the port's)."""
    from repro_torch.common import init_params
    jc = dataclasses.replace(jax_smoke("h2o-danube-3-4b"), dtype=jnp.float32,
                             d_model=512, n_layers=layers)
    pc = dataclasses.replace(get_smoke_config("h2o-danube-3-4b"),
                             dtype=torch.float32, d_model=512,
                             n_layers=layers)
    kw = dict(microbatches=1, moment_dtype="fp32", accum_dtype="fp32")
    pt = Trainer(build_model(pc), TrainConfig(**kw))
    jt = JaxTrainer(jax_build(jc), JaxTrainConfig(**kw))
    p = init_params(_f32_draws(pt.model.decls()),
                    torch.Generator(device="cpu").manual_seed(0), "cpu")
    ps = {"params": p, "opt": pt.opt.init(p)}
    jp = jax.tree.map(jnp.asarray,
                      convert.train_state_to_numpy(ps)["params"])
    b = next(jax_batches(jc, JaxShape("t", seq, 1, "train")))
    _, jm = jax.jit(jt.train_step)({"params": jp, "opt": jt.opt.init(jp)},
                                   {k: jnp.asarray(v) for k, v in b.items()})
    _, pm = pt.train_step(ps, {k: torch.from_numpy(v) for k, v in b.items()})
    return float(jm["grad_norm"]), float(pm["grad_norm"])


def test_stock_init_gradients_explode_with_depth_in_jax_too():
    """C11: under the stock init the grad norm grows by orders of magnitude
    from 2 to 24 layers in the JAX package's own ``Trainer.train_step`` as
    in the port's (measured 9.7 -> 3.7e3 -> 1.0e6 and 10.2 -> 3.6e3 ->
    3.9e5): shared semantics, not a port fault.  The scores reach a std in
    the hundreds and the softmax is nearly an argmax, so the gradient is
    ill-conditioned and a float32 order moves it: the two stay within a
    factor of 10 at every depth, not within a rounding."""
    norms = [_c11_norms(layers) for layers in C11_DEPTHS]
    for series in zip(*norms):
        assert all(math.isfinite(x) for x in series), series
        assert series[0] < series[1] < series[2], series
        assert series[2] >= 1e4 * series[0], series
    for jax_n, port_n in norms:
        assert jax_n / 10 <= port_n <= 10 * jax_n, norms
