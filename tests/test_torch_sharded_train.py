"""The sharded train step and the sequence-sharded decode on four gloo
ranks on the CPU, against the one-rank port and the JAX package.

One group of four ranks is started by a module-scoped fixture
(``repro_torch.launch.mesh.run_ranks``: fresh interpreters, one thread
each, killed together on a 120 s timeout: ~10 s alone, more when the
whole suite loads the machine); the ranks load this file, so it
imports no JAX at module level, and the pytest process never initialises
a process group.

(a) ``Trainer.sharded_step`` on internlm2-20b's smoke config in float32
    (the float32 configuration's bf16 init cast to float32, as the
    reference's own mesh test does), microbatches 2, fp32 accumulation, a
    batch of 4 x 32 tokens: on meshes (data 2 x model 2) and (1 x 4),
    ``hoist_gather`` off and on; (2 x 2) with int8 moments; (2 x 2) under
    remat.  On (1 x 4) the 2 KV heads are replicated over 4 model ranks.
    Each rank holds exactly its ``state_specs`` blocks.  Held against the
    port's one-rank ``Trainer.train_step`` and ``jax.jit`` of the JAX
    ``Trainer.train_step`` on the same state and batch with the bounds of
    ``tests/test_distributed.py::test_sharded_train_step_matches_single
    _device`` (which fails on its own 8-device mesh, ROADMAP C2): loss
    within 1e-4; every parameter within 2.5 x 3e-4 (step-1 Adam moves a
    coordinate by about lr x sign(g), so a near-zero gradient summed in
    another order may flip).  Against the port, the gradient norm within
    1e-4 relative (float32 sums of ~1.5e5 squares in another order: 1.4e-5
    and 3.0e-5 apart measured) and the fp32 moments within 1e-4 of their
    largest value (the clip divides by that norm).
    The bytes each rank's collectives moved equal
    ``roofline.sharded_train_bytes`` exactly.
(a') The MoE family's step: dbrx-132b's smoke configuration (every layer
    MoE, ``head_tp``, 4 experts top-2) at ``capacity_factor`` 8.0, so no
    copy drops (the reference's own EP test's factor), in float32 (its
    init cast), a batch of 8 x 32 tokens, on meshes (2 x 2) and (4 x 1):
    the experts expert-parallel over ``data`` and split over ``model``,
    the tokens exchanged by an autograd all-to-all.  Held to the port's
    one-rank step (which runs ``moe_dense``) and to JAX's at (a)'s bounds,
    the gradient through the norm and the moments (the exchange's
    backward carries every token's gradient back from the experts); every
    copy kept; the bytes (all-to-all included) equal the reckoning.
(a'') The elastic re-mesh of the sharded state: the (2 x 2) MoE state after
    its step, saved by ``Checkpointer.save(specs=, mesh=)`` (gathered,
    written by rank 0), restored under (1 x 4) and (4 x 1): each rank's
    blocks equal ``local_block`` of the saved state bit for bit, and one
    more sharded step from them is held to the port's one-rank step from
    the saved state at (a)'s bounds.
(b) ``ops.sharded_decode_attention``: danube's head layout (K 2, G 4, D 64
    here), B 2, T 1,024 split over the four ranks, ``pos`` inside rank 2's
    slice (rank 3's slice fully masked): float32 within 2e-5 of the
    one-rank ``ops.decode_attention`` and of the JAX
    ``decode_attention_kernel`` (interpret mode) + ``merge_partials`` over
    the same slices; bf16 within one bf16 ulp of the one-rank decode.
(c) In this process: the reference test's eight-slice case (B 1, T 2,048,
    H 4, K 2, D 64, pos 1,800) through ``decode_attention_partials`` and
    ``merge_partials`` against JAX's kernel + merge and
    ``decode_attention_ref`` within 2e-5; the plain partials against the
    JAX kernel's at the same split (256), split for split.
(d) In this process: the plans the sharded step does not cover
    (llama4-maverick's shared expert, a mixed MoE / dense plan, a
    ``seq_sp`` MoE configuration, the recurrent and encoder-decoder
    families) raise, naming what is missing.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.analysis.roofline import (collective_bytes,  # noqa: E402
                                           sharded_train_bytes)
from repro_torch.common import (cast_tree, gather_tree,  # noqa: E402
                                shard_tree)
from repro_torch.common.params import (local_block, map_state,  # noqa: E402
                                       spec_leaves, state_tensors)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.distributed.sharding import rules_for  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.zoo import input_logical  # noqa: E402
from repro_torch.training import Trainer, tree_leaves  # noqa: E402

ARCH = "internlm2-20b"
WORLD = 4
TIMEOUT = 120.0
SEQ, BATCH, MICRO = 32, 4, 2
LOSS_TOL = 1e-4
PARAM_TOL = 2.5 * 3e-4
# (mesh, moments, hoist_gather, remat)
CASES = [((2, 2), "fp32", False, "none"), ((2, 2), "fp32", True, "none"),
         ((1, 4), "fp32", False, "none"), ((1, 4), "fp32", True, "none"),
         ((2, 2), "int8", False, "none"), ((2, 2), "fp32", False, "full")]
IDS = [f"{m[0]}x{m[1]}-{mo}-{'hoist' if h else 'gather'}-remat_{r}"
       for m, mo, h, r in CASES]
MOE_ARCH, MOE_BATCH = "dbrx-132b", 8
MOE_MESHES = ((2, 2), (4, 1))
REMESH = ((1, 4), (4, 1))
SP_B, SP_T, SP_K, SP_G, SP_D = 2, 1024, 2, 4, 64
SP_POS = (600, 537)          # inside rank 2's slice [512, 768)
SP_TOL = 2e-5


def _cfg(remat):
    return dataclasses.replace(get_smoke_config(ARCH), dtype=torch.float32,
                               remat=remat)


def _moe_cfg():
    return dataclasses.replace(get_smoke_config(MOE_ARCH),
                               dtype=torch.float32, capacity_factor=8.0)


def _tcfg(moments, hoist=False):
    return TrainConfig(microbatches=MICRO, moment_dtype=moments,
                       accum_dtype="fp32", hoist_gather=hoist)


def _tokens(cfg, batch=BATCH):
    return np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, SEQ)).astype(np.int32)


def _sp_inputs(dtype):
    rng = np.random.RandomState(3)
    h = SP_K * SP_G
    q = rng.randn(SP_B, 1, h, SP_D).astype(np.float32)
    k = rng.randn(SP_B, SP_T, SP_K, SP_D).astype(np.float32)
    v = rng.randn(SP_B, SP_T, SP_K, SP_D).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dtype) for x in (q, k, v))


def _sp_rank(rank):
    """This rank's sequence-sharded decode in float32 and bf16."""
    mesh = pmesh.Mesh.build((WORLD,), ("seq",))
    t_loc = SP_T // WORLD
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _sp_inputs(dtype)
        sl = slice(rank * t_loc, (rank + 1) * t_loc)
        out[dtype] = dops.sharded_decode_attention(
            q, k[:, sl].contiguous(), v[:, sl].contiguous(),
            torch.tensor(SP_POS, dtype=torch.int32), offset=rank * t_loc,
            group=mesh.group("seq"))
    return out


def _step_on(tr, local, batch, mesh, specs):
    """One sharded step of ``tr`` from this rank's ``local`` state on
    ``mesh`` over its rows of the whole ``batch``."""
    cfg = tr.model.cfg
    rules = rules_for(cfg, mesh, "train")
    local_batch = shard_tree(batch, input_logical(
        cfg, ShapeConfig("t", SEQ, batch["tokens"].shape[0], "train"),
        rules), mesh)
    step = tr.sharded_step(mesh, rules)
    pmesh.reset_collectives()
    local, metrics = step(local, local_batch)
    return dict(local=local, metrics={k: float(v) for k, v in
                                      metrics.items()},
                moved=collective_bytes(), rows=local_batch["tokens"].shape[0],
                kept=[int(x) for x in step.moe_kept])


def _moe_rank(args):
    """(a') on both meshes, then (a''): the (2 x 2) state saved and
    restored under each of REMESH, one more step there."""
    from repro_torch.ft.checkpoint import Checkpointer
    cfg = _moe_cfg()
    tr = Trainer(build_model(cfg), _tcfg("fp32"))
    batch = {"tokens": torch.from_numpy(args["moe_tokens"])}
    out = {}
    for shape in MOE_MESHES:
        mesh = pmesh.make_host_mesh(*shape)
        specs = tr.state_specs(rules_for(cfg, mesh, "train"))
        got = _step_on(tr, shard_tree(_state(cfg, tr, args["moe_params"]),
                                      specs, mesh), batch, mesh, specs)
        local = got.pop("local")
        got["state"] = gather_tree(local, specs, mesh)
        out[shape] = got
        if shape == (2, 2):
            ck = Checkpointer(args["ckpt"])
            ck.save(1, local, specs=specs, mesh=mesh)
            saved = got["state"]
    for shape in REMESH:
        mesh = pmesh.make_host_mesh(*shape)
        specs = tr.state_specs(rules_for(cfg, mesh, "train"))
        restored, step = ck.restore(_on_cpu(cast_tree(tr.abstract_state())),
                                    specs=specs, mesh=mesh)
        want = shard_tree(saved, specs, mesh)
        same = step == 1 and all(
            torch.equal(a, b) for a, b in zip(state_tensors(restored),
                                              state_tensors(want)))
        got = _step_on(tr, restored, batch, mesh, specs)
        got["state"] = gather_tree(got.pop("local"), specs, mesh)
        out[("remesh", shape)] = dict(got, same=same)
    return out


def _on_cpu(tree):
    """A meta-device state tree as zero-size CPU stand-ins: ``restore``
    reads only each leaf's dtype and device."""
    return map_state(lambda t: torch.empty((), dtype=t.dtype), tree)


def _rank(rank, world, device, args):
    """Every case of (a) on this rank, then (a'), (a'') and (b)."""
    out = {}
    for case in CASES:
        shape, moments, hoist, remat = case
        cfg = _cfg(remat)
        tr = Trainer(build_model(cfg), _tcfg(moments, hoist))
        state = _state(cfg, tr, args["params"])
        mesh = pmesh.make_host_mesh(*shape)
        rules = rules_for(cfg, mesh, "train")
        specs = tr.state_specs(rules)
        local = shard_tree(state, specs, mesh)
        batch = {"tokens": torch.from_numpy(args["tokens"])}
        local_batch = shard_tree(batch, input_logical(
            cfg, ShapeConfig("t", SEQ, BATCH, "train"), rules), mesh)
        step = tr.sharded_step(mesh, rules)
        pmesh.reset_collectives()
        local, metrics = step(local, local_batch)
        moved = collective_bytes()
        want_shapes = [tuple(local_block(t, s, mesh).shape) for t, s in
                       zip(tree_leaves(state["params"]),
                           spec_leaves(specs["params"]))]
        got_shapes = [tuple(t.shape) for t in tree_leaves(local["params"])]
        out[case] = dict(
            state=gather_tree(local, specs, mesh),
            metrics={k: float(v) for k, v in metrics.items()},
            moved=moved, rows=local_batch["tokens"].shape[0],
            layout=got_shapes == want_shapes)
    out["moe"] = _moe_rank(args)
    out["sp"] = _sp_rank(rank)
    return out


@pytest.fixture(scope="module")
def group():
    """The rank group, started in a thread once the parameters are drawn,
    and meanwhile the JAX and one-rank steps in this process (once for
    each kind of moments: remat recomputes the same function)."""
    import shutil
    import tempfile
    import threading

    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.models import build_model as jax_build
    from repro.training import Trainer as JaxTrainer

    tokens = _tokens(_cfg("none"))
    jm = jax_build(dataclasses.replace(jax_smoke(ARCH), dtype=jnp.float32))
    # the float32 configuration's bf16 init cast to float32 (C15)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    params = jax.tree.map(np.asarray, jp)
    jmoe = jax_build(dataclasses.replace(jax_smoke(MOE_ARCH),
                                         dtype=jnp.float32,
                                         capacity_factor=8.0))
    jmp = jax.tree.map(lambda x: x.astype(jnp.float32),
                       jmoe.init(jax.random.PRNGKey(1)))
    moe_params = jax.tree.map(np.asarray, jmp)
    moe_tokens = _tokens(_moe_cfg(), MOE_BATCH)
    ckpt = tempfile.mkdtemp(prefix="remesh-")
    ranks = []
    worker = threading.Thread(target=lambda: ranks.extend(pmesh.run_ranks(
        f"{__file__}:_rank", WORLD, backend="gloo", device="cpu",
        timeout=TIMEOUT, args=dict(params=params, tokens=tokens,
                                   moe_params=moe_params,
                                   moe_tokens=moe_tokens, ckpt=ckpt))))
    worker.start()
    jax_out, port_out = {}, {}
    for moments in ("fp32", "int8"):
        jt = JaxTrainer(jm, JaxTrainConfig(
            microbatches=MICRO, moment_dtype=moments, accum_dtype="fp32"))
        new, met = jax.jit(jt.train_step)(
            {"params": jp, "opt": jt.opt.init(jp)},
            {"tokens": jnp.asarray(tokens)})
        jax_out[moments] = (jax.tree.map(np.asarray, new["params"]),
                            float(met["loss"]))
        ps, pm = _one_rank(params, moments)
        port_out[moments] = (ps, {k: float(v) for k, v in pm.items()})
    jt = JaxTrainer(jmoe, JaxTrainConfig(microbatches=MICRO,
                                         moment_dtype="fp32",
                                         accum_dtype="fp32"))
    new, met = jax.jit(jt.train_step)({"params": jmp,
                                       "opt": jt.opt.init(jmp)},
                                      {"tokens": jnp.asarray(moe_tokens)})
    jax_out["moe"] = (jax.tree.map(np.asarray, new["params"]),
                      float(met["loss"]))
    moe_tr = Trainer(build_model(_moe_cfg()), _tcfg("fp32"))
    moe_batch = {"tokens": torch.from_numpy(moe_tokens)}
    ps, pm = moe_tr.train_step(_state(_moe_cfg(), moe_tr, moe_params),
                               moe_batch)
    port_out["moe"] = (ps, {k: float(v) for k, v in pm.items()})
    worker.join()
    shutil.rmtree(ckpt, ignore_errors=True)
    assert len(ranks) == WORLD, "the rank group failed"
    # the one-rank step from the saved (2 x 2) state, for the re-mesh
    saved = ranks[0]["moe"][(2, 2)]["state"]
    ps, pm = moe_tr.train_step(_clone(saved), moe_batch)
    port_out["remesh"] = (ps, {k: float(v) for k, v in pm.items()})
    return dict(ranks=ranks, jax=jax_out, port=port_out, tokens=tokens)


def _clone(state):
    """A copy of a state tree (the one-rank step updates in place)."""
    return map_state(lambda t: t.clone(), state)


def _state(cfg, tr, params):
    """The port's state: ``params`` (NumPy, the JAX layout) carried over,
    zeroed moments."""
    p = convert.model_params_from_numpy(cfg, params, "cpu")
    return {"params": p, "opt": tr.opt.init(p)}


def _one_rank(params, moments):
    cfg = _cfg("none")
    tr = Trainer(build_model(cfg), _tcfg(moments))
    return tr.train_step(_state(cfg, tr, params),
                         {"tokens": torch.from_numpy(_tokens(cfg))})


def _max_gap(a_leaves, b_leaves):
    return max(float(np.max(np.abs(np.asarray(a, np.float32)
                                   - np.asarray(b, np.float32))))
               for a, b in zip(a_leaves, b_leaves))


def _np(leaves):
    return [t.detach().float().numpy() for t in leaves]


def _hold_to_port(got, ps, pm, r, moments="fp32"):
    """(a)'s bounds: a rank's step against the port's one-rank step."""
    assert abs(got["metrics"]["loss"] - pm["loss"]) < LOSS_TOL, r
    assert abs(got["metrics"]["grad_norm"] - pm["grad_norm"]) \
        <= 1e-4 * pm["grad_norm"], r
    gap = _max_gap(_np(tree_leaves(got["state"]["params"])),
                   _np(tree_leaves(ps["params"])))
    assert gap < PARAM_TOL, (r, gap)
    assert got["state"]["opt"]["step"] == ps["opt"]["step"]
    if moments == "fp32":
        for key in ("m", "v"):
            want = tree_leaves(ps["opt"][key])
            top = max(float(t.abs().max()) for t in want)
            assert _max_gap(_np(tree_leaves(got["state"]["opt"][key])),
                            _np(want)) <= 1e-4 * top, (r, key)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_step_matches_the_one_rank_port(group, case):
    moments = case[1]
    ps, pm = group["port"][moments]
    for r, rk in enumerate(group["ranks"]):
        assert rk[case]["state"]["opt"]["step"] == 1
        _hold_to_port(rk[case], ps, pm, r, moments)


MOE_IDS = [f"{m[0]}x{m[1]}" for m in MOE_MESHES]


@pytest.mark.parametrize("shape", MOE_MESHES, ids=MOE_IDS)
def test_moe_sharded_step_matches_the_one_rank_port(group, shape):
    """(a'): against the one-rank step (``moe_dense``), every copy kept."""
    ps, pm = group["port"]["moe"]
    for r, rk in enumerate(group["ranks"]):
        got = rk["moe"][shape]
        _hold_to_port(got, ps, pm, r)
        kept, copies = got["kept"]
        assert copies > 0 and kept == copies, (r, got["kept"])


@pytest.mark.parametrize("shape", MOE_MESHES, ids=MOE_IDS)
def test_moe_sharded_step_matches_jax(group, shape):
    jparams, jloss = group["jax"]["moe"]
    for r, rk in enumerate(group["ranks"]):
        got = rk["moe"][shape]
        assert abs(got["metrics"]["loss"] - jloss) < LOSS_TOL, r
        gap = _max_gap(_np(tree_leaves(got["state"]["params"])),
                       _jax_leaves(jparams))
        assert gap < PARAM_TOL, (r, gap)


@pytest.mark.parametrize("shape", MOE_MESHES, ids=MOE_IDS)
def test_moe_counted_bytes_equal_the_reckoning(group, shape):
    cfg = _moe_cfg()
    tr = Trainer(build_model(cfg), _tcfg("fp32"))
    params = group["port"]["moe"][0]["params"]
    rules = rules_for(cfg, pmesh.Mesh(shape, ("data", "model")), "train")
    for rk in group["ranks"]:
        got = rk["moe"][shape]
        want = sharded_train_bytes(tr.model, tr.tcfg, params, rules,
                                   dict(data=shape[0], model=shape[1]),
                                   got["rows"], SEQ)
        assert want["all-to-all"] > 0
        for kind, n in want.items():
            assert got["moved"][kind] == n, (kind, got["moved"], want)


@pytest.mark.parametrize("shape", REMESH, ids=[f"{m[0]}x{m[1]}"
                                                for m in REMESH])
def test_remesh_restores_the_blocks_and_steps_on(group, shape):
    """(a''): the (2 x 2) state restored under another mesh holds exactly
    its blocks there, and the next step matches the one-rank step from
    the saved state."""
    ps, pm = group["port"]["remesh"]
    for r, rk in enumerate(group["ranks"]):
        got = rk["moe"][("remesh", shape)]
        assert got["same"], r
        assert got["state"]["opt"]["step"] == 2
        _hold_to_port(got, ps, pm, r)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_step_matches_jax(group, case):
    jparams, jloss = group["jax"][case[1]]
    from repro_torch.training.optim import tree_leaves as leaves
    for r, rk in enumerate(group["ranks"]):
        got = rk[case]
        assert abs(got["metrics"]["loss"] - jloss) < LOSS_TOL, r
        gap = _max_gap(_np(leaves(got["state"]["params"])),
                       _jax_leaves(jparams))
        assert gap < PARAM_TOL, (r, gap)


def _jax_leaves(tree):
    """A JAX parameter tree's leaves in the port's order (dict keys
    sorted, as ``jax.tree.leaves`` flattens them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _jax_leaves(v)]
    return [tree]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_state_holds_its_blocks(group, case):
    """Each rank's local leaves are its ``state_specs`` blocks, and the
    state gathered after the step is the same on every rank."""
    ranks = group["ranks"]
    assert all(rk[case]["layout"] for rk in ranks)
    first = _state_arrays(ranks[0][case]["state"])
    for rk in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(first, _state_arrays(rk[case]["state"])))


def _state_arrays(state):
    """The parameters and both moments (int8: values and scales) as
    NumPy."""
    out = _np(tree_leaves(state["params"]))
    for key in ("m", "v"):
        for leaf in tree_leaves(state["opt"][key]):
            out += (_np([leaf.q, leaf.scale]) if hasattr(leaf, "q")
                    else _np([leaf]))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_counted_bytes_equal_the_reckoning(group, case):
    shape, moments, hoist, remat = case
    cfg = _cfg(remat)
    tr = Trainer(build_model(cfg), _tcfg(moments, hoist))
    params = group["port"][moments][0]["params"]
    rules = rules_for(cfg, pmesh.Mesh(shape, ("data", "model")), "train")
    for rk in group["ranks"]:
        got = rk[case]
        want = sharded_train_bytes(tr.model, tr.tcfg, params, rules,
                                   dict(data=shape[0], model=shape[1]),
                                   got["rows"], SEQ)
        for kind, n in want.items():
            assert got["moved"][kind] == n, (kind, got["moved"], want)
        assert got["moved"]["all-to-all"] == 0


def _ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of x (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _jax_slices(q, k, v, pos, n, bs):
    """JAX's kernel partials over ``n`` slices of T (interpret mode, one
    compile for the slices) and its merge."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.decode_attention.kernel import decode_attention_kernel
    from repro.kernels.decode_attention.ops import merge_partials
    t = k.shape[1]
    kernel = jax.jit(lambda *a: decode_attention_kernel(*a, bs=bs))
    parts = [kernel(
        jnp.asarray(q), jnp.asarray(k[:, s * t // n:(s + 1) * t // n]),
        jnp.asarray(v[:, s * t // n:(s + 1) * t // n]),
        jnp.maximum(jnp.asarray(pos) - s * t // n, 0))
        for s in range(n)]
    o, m, l = (jnp.concatenate([p[i] for p in parts], axis=2)
               for i in range(3))
    b, _, h, d = q.shape
    return np.asarray(merge_partials(o, m, l).reshape(b, 1, h, d))


def test_sequence_sharded_decode_four_ranks_float32(group):
    q, k, v = _sp_inputs(torch.float32)
    pos = torch.tensor(SP_POS, dtype=torch.int32)
    one = dops.decode_attention(q, k, v, pos)
    via_jax = _jax_slices(q.numpy(), k.numpy(), v.numpy(),
                          np.asarray(SP_POS, np.int32), WORLD, 128)
    for rk in group["ranks"]:
        got = rk["sp"][torch.float32]
        assert float((got - one).abs().max()) <= SP_TOL
        assert float(np.abs(got.numpy() - via_jax).max()) <= SP_TOL


def test_sequence_sharded_decode_four_ranks_bf16(group):
    q, k, v = _sp_inputs(torch.bfloat16)
    one = dops.decode_attention(q, k, v, torch.tensor(SP_POS,
                                                      dtype=torch.int32))
    for rk in group["ranks"]:
        got = rk["sp"][torch.bfloat16]
        assert got.dtype == torch.bfloat16
        assert bool(((got.float() - one.float()).abs()
                     <= _ulp_bf16(one)).all())


def test_fully_masked_slice_gives_empty_partials():
    """Rank 3's slice lies past pos: every split is (0, NEG_INF, 0)."""
    q, k, v = _sp_inputs(torch.float32)
    t_loc = SP_T // WORLD
    o, m, l = dops.decode_attention_partials(
        q, k[:, 3 * t_loc:].contiguous(), v[:, 3 * t_loc:].contiguous(),
        torch.clamp(torch.tensor(SP_POS) - 3 * t_loc, min=0))
    assert bool((o == 0).all()) and bool((l == 0).all())
    assert bool((m == -1e30).all())


def test_eight_slice_decode_matches_jax():
    """The reference test's case (``tests/test_distributed.py::
    test_sp_decode_cross_shard_merge_matches_kernel``) in one process."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ref import decode_attention_ref
    rng = np.random.RandomState(0)
    b, t, h, kh, d, pos, n = 1, 2048, 4, 2, 64, 1800, 8
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k = rng.randn(b, t, kh, d).astype(np.float32)
    v = rng.randn(b, t, kh, d).astype(np.float32)
    parts = [dops.decode_attention_partials(
        torch.from_numpy(q), torch.from_numpy(k[:, s * t // n:
                                                (s + 1) * t // n].copy()),
        torch.from_numpy(v[:, s * t // n:(s + 1) * t // n].copy()),
        max(pos - s * t // n, 0)) for s in range(n)]
    o, m, l = (torch.cat([p[i] for p in parts], dim=2) for i in range(3))
    got = dops.merge_partials(o, m, l).reshape(b, 1, h, d).numpy()
    assert np.abs(got - _jax_slices(q, k, v, pos, n, 128)).max() <= SP_TOL
    want = np.asarray(decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), pos))
    assert np.abs(got - want).max() <= SP_TOL


def test_plain_partials_match_the_jax_kernel_split_for_split():
    """At the JAX kernel's split of 256: o, m and l of every split with a
    valid position within 2e-5 of the kernel's (relative to the largest
    o); a split with none is (0, NEG_INF, 0) here, the kernel's (sum of
    V, NEG_INF, 256), which the merge annihilates either way."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention.kernel import decode_attention_kernel
    q, k, v = (x.numpy() for x in _sp_inputs(torch.float32))
    pos = np.asarray(SP_POS, np.int32)
    jo, jm, jl = (np.asarray(x) for x in decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        bs=256))
    po, pm, pl = (x.numpy() for x in dops.decode_attention_partials(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos)))
    assert po.shape == jo.shape and pm.shape == jm.shape
    live = (np.arange(SP_T // 256)[None, :] * 256 < pos[:, None])
    live = live[:, None, :, None]                       # (B,1,S,1)
    o_tol = SP_TOL * float(np.abs(jo).max())
    l_tol = SP_TOL * float(np.abs(jl).max())
    assert np.abs(np.where(live[..., None], po - jo, 0)).max() <= o_tol
    assert np.abs(np.where(live, pm - jm, 0)).max() <= SP_TOL
    assert np.abs(np.where(live, pl - jl, 0)).max() <= l_tol
    assert (np.where(live, 0, pm) == np.where(live, 0, np.float32(-1e30))
            ).all()
    assert (np.where(live, 0, pl) == 0).all()


def test_no_process_group_in_the_pytest_process(group):
    import torch.distributed as dist
    assert len(group["ranks"]) == WORLD
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,change,missing", [
    ("llama4-maverick-400b-a17b", {}, "shared expert"),
    (MOE_ARCH, {"moe_every": 2}, "mixes MoE and dense"),
    (MOE_ARCH, {"attn_policy": "seq_sp"}, "'seq_sp' attention policy"),
    ("hymba-1.5b", {}, "recurrent"),
    ("seamless-m4t-large-v2", {}, "encoder-decoder")],
    ids=["maverick", "moe_every2", "moe_seq_sp", "hymba", "seamless"])
def test_unported_plans_raise_naming_what_is_missing(arch, change, missing):
    """The plans the sharded step does not cover raise before any
    collective, naming what is missing (a shape-only mesh will do)."""
    cfg = dataclasses.replace(get_smoke_config(arch), **change)
    tr = Trainer(build_model(cfg), _tcfg("fp32"))
    mesh = pmesh.Mesh((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match=missing):
        tr.sharded_step(mesh, rules_for(cfg, mesh, "train"))
