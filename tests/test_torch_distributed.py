"""Distribution on ``torch.distributed`` (gloo, four ranks on the CPU)
against the JAX package.

One group of ranks is started by a module-scoped fixture with
``repro_torch.launch.mesh.run_ranks`` (fresh interpreters meeting through a
file store, one thread each, killed together on a 60 s timeout) and runs
every case of (c)–(e); the tests below hold its results.  The ranks load
this file, so it imports no JAX at module level.

(c) ``models.moe.moe_ep`` on the dbrx-132b smoke config in float32 over
    (data 2 × model 2) and (data 4 × model 1), each rank holding its slice
    of one set of parameters (``shard_moe_params``) and its data
    coordinate's tokens: at capacity_factor 8 (no drops) the tokens'
    outputs equal the port's ``moe_dense`` within 1e-4; at capacity_factor
    1 each rank's output equals the JAX ``_moe_local(n_dest=1,
    axis_*=None)`` on its tokens within 1e-5, with the same dropped
    (token, expert) copies, and some dropped.  ``moe_block`` picks the
    expert-parallel path under the mesh.  The collectives move what they
    should: two all-to-alls of the (E, capacity, d) buffer over ``data``
    and one all-reduce of the (T_loc, d) output over ``model``.
(d) ``distributed.compression.compressed_psum``, int8 and bf16, sizes
    1,000 and (37, 91), 3 steps with error feedback, against
    ``jax.vmap`` of the reference's ``compressed_psum`` over axis ``"i"``
    and the 4 stacked inputs: the residuals exact; the mean within 1e-6
    (int8: float32 sums of four values in another order) or, in bf16,
    within 2^-6 of the mean magnitude of the four values sent (the
    reference reduces in bf16; gloo rounds each of the three partial sums
    to bf16 and XLA rounds the sum once, each rounding at most 2^-9 of the
    summands' magnitude).
(e) ``distributed.pipeline.pipeline_forward``, 4 stages × 8 microbatches,
    against the JAX sequential product within 1e-5; each stage but the
    last sends each microbatch once.
(f) ``rules_for``, ``base_rules``, ``query_rules``, ``dp_axes`` and
    ``dp_degree`` equal to the reference's tables entry for entry for all
    ten configs and the three modes at mesh shapes (2, 4), (16, 16) and
    (2, 16, 16), on meshes built from a shape alone (the reference's on
    ``jax.sharding.AbstractMesh``).
(g) The harness: a rank that raises makes ``run_ranks`` raise with its
    traceback; a rank that sleeps past a 3 s timeout is killed; neither
    leaves a process behind.
"""
import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.roofline import collective_bytes  # noqa: E402
from repro_torch.common.sharding import ShardingRules, use_mesh  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.distributed.compression import compressed_psum  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_forward  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

WORLD = 4
TIMEOUT = 60.0
MOE_ARCH = "dbrx-132b"
MOE_SHAPES = ((2, 2), (4, 1))
MOE_CASES = [(shape, cf) for shape in MOE_SHAPES for cf in (8.0, 1.0)]
TOKENS = (4, 32)                        # (batch, seq): 128 tokens
COMP_CASES = [(method, shape) for method in ("int8", "bf16")
              for shape in ((1000,), (37, 91))]
STEPS = 3
STAGES, MICRO, MB, WIDTH = 4, 8, 4, 16


def _moe_cfg(cf):
    return dataclasses.replace(get_smoke_config(MOE_ARCH),
                               dtype=torch.float32, capacity_factor=cf)


def _moe_inputs():
    cfg = _moe_cfg(1.0)
    rng = np.random.default_rng(0)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    params = {"router": rng.normal(0, d ** -0.5, (d, e)),
              "w_gate": rng.normal(0, d ** -0.5, (e, d, ff)),
              "w_up": rng.normal(0, d ** -0.5, (e, d, ff)),
              "w_down": rng.normal(0, ff ** -0.5, (e, ff, d))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(0, 1, TOKENS + (d,)).astype(np.float32)
    return params, x


def _local_tokens(x, shape, data_coord):
    b = x.shape[0] // shape[0]
    return x[data_coord * b:(data_coord + 1) * b]


def _moe_rank(params, x):
    out = {}
    for shape, cf in MOE_CASES:
        mesh = pmesh.make_host_mesh(*shape)
        cfg = _moe_cfg(cf)
        p = moe.shard_moe_params(cfg, params, mesh)
        xl = _local_tokens(x, shape, mesh.coords["data"])
        stats = {}
        with use_mesh(mesh, ShardingRules({})):
            pmesh.reset_collectives()
            y = moe.moe_ep(cfg, p, xl, stats=stats)
            moved = collective_bytes()
            block = moe.moe_block(cfg, p, xl)
        out[(shape, cf)] = dict(y=y, keep=stats["keep"], moved=moved,
                                block=block)
    return out


def _comp_rank(rank, xs):
    mesh = pmesh.Mesh.build((WORLD,), ("i",))
    out = {}
    for method, shape in COMP_CASES:
        err, steps = None, []
        for s in range(STEPS):
            mean, err = compressed_psum(torch.tensor(xs[(method, shape)][s,
                                                                         rank]),
                                        mesh.group("i"), err, method=method)
            steps.append((mean, err))
        out[(method, shape)] = steps
    return out


def _stage(w, h):
    return torch.tanh(h @ w)


def _pipe_rank(rank, ws, x):
    mesh = pmesh.Mesh.build((STAGES,), ("stage",))
    pmesh.reset_collectives()
    y = pipeline_forward(mesh, _stage, MICRO)(ws[rank], x)
    return y, collective_bytes()


def _production_mesh_refusal():
    try:
        pmesh.make_production_mesh()
    except ValueError as err:
        return str(err)
    return None


def _rank(rank, world, device, args):
    moe_args, comp_args, pipe_args = args
    return (_moe_rank(*moe_args), _comp_rank(rank, comp_args),
            _pipe_rank(rank, *pipe_args), _production_mesh_refusal())


def _comp_inputs():
    rng = np.random.default_rng(1)
    return {case: rng.normal(0, 1, (STEPS, WORLD) + case[1]).astype(
        np.float32) for case in COMP_CASES}


def _pipe_inputs():
    rng = np.random.default_rng(2)
    ws = rng.normal(0, WIDTH ** -0.5, (STAGES, WIDTH, WIDTH))
    x = rng.normal(0, 1, (MICRO, MB, WIDTH))
    return (torch.tensor(ws, dtype=torch.float32),
            torch.tensor(x, dtype=torch.float32))


@pytest.fixture(scope="module")
def ranks():
    params, x = _moe_inputs()
    args = (({k: torch.tensor(v) for k, v in params.items()},
             torch.tensor(x)), _comp_inputs(), _pipe_inputs())
    return args, pmesh.run_ranks(f"{__file__}:_rank", WORLD, backend="gloo",
                                 device="cpu", timeout=TIMEOUT, args=args)


# --- (c) expert-parallel MoE -------------------------------------------------

def _moe_id(case):
    return f"{case[0][0]}x{case[0][1]}-cf{case[1]:g}"


def _data_coord(rank, shape):
    return rank // shape[1]


@pytest.mark.parametrize("shape", MOE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_ep_equals_moe_dense_without_drops(ranks, shape):
    (mo, _, _), results = ranks
    params, x = mo
    cfg = _moe_cfg(8.0)
    want = moe.moe_dense(cfg, params, x)
    for rank in range(WORLD):
        got = results[rank][0][(shape, 8.0)]
        assert bool(got["keep"].all())
        xl_want = _local_tokens(want, shape, _data_coord(rank, shape))
        assert float((got["y"] - xl_want).abs().max()) <= 1e-4, rank


def _jax_local(cfg_port, params, xl):
    """The JAX ``_moe_local(n_dest=1)`` on one rank's tokens, and its kept
    (token, expert) copies by the reference's rule."""
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import moe as jmoe
    cfg = dataclasses.replace(jax_smoke(MOE_ARCH), dtype=jnp.float32,
                              capacity_factor=cfg_port.capacity_factor)
    p = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    xt = jnp.asarray(xl.reshape(-1, cfg.d_model).numpy())
    y = jmoe._moe_local(cfg, xt, p["router"], p["w_gate"], p["w_up"],
                        p["w_down"], n_dest=1, axis_data=None,
                        axis_model=None)
    _, idx, _ = jmoe._router_topk(xt, p["router"], cfg.top_k)
    flat = np.asarray(idx).reshape(-1)
    onehot = np.eye(cfg.n_experts, dtype=np.int64)[flat]
    slot = ((np.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    cap = max(4, int(-(-xt.shape[0] * cfg.top_k * cfg.capacity_factor
                       // cfg.n_experts)))
    return np.asarray(y).reshape(xl.shape), slot < cap


@pytest.mark.parametrize("shape", MOE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_ep_with_drops_equals_the_jax_local_body(ranks, shape):
    (mo, _, _), results = ranks
    params, x = mo
    cfg = _moe_cfg(1.0)
    dropped = 0
    for rank in range(WORLD):
        got = results[rank][0][(shape, 1.0)]
        xl = _local_tokens(x, shape, _data_coord(rank, shape))
        want, keep = _jax_local(cfg, params, xl)
        assert np.array_equal(got["keep"].numpy(), keep), rank
        assert np.abs(got["y"].numpy() - want).max() <= 1e-5, rank
        dropped += int((~keep).sum())
    assert dropped > 0


@pytest.mark.parametrize("case", MOE_CASES, ids=_moe_id)
def test_moe_ep_moves_the_stated_bytes(ranks, case):
    (shape, cf), (_, results) = case, ranks
    cfg = _moe_cfg(cf)
    t_loc = TOKENS[0] * TOKENS[1] // shape[0]
    cap = moe._capacity(cfg, t_loc)
    for rank in range(WORLD):
        moved = results[rank][0][case]["moved"]
        a2a = 2 * cfg.n_experts * cap * cfg.d_model * 4 if shape[0] > 1 else 0
        ar = t_loc * cfg.d_model * 4 if shape[1] > 1 else 0
        assert moved["all-to-all"] == a2a and moved["all-reduce"] == ar
        assert moved["count"] == 2 * (shape[0] > 1) + (shape[1] > 1)


@pytest.mark.parametrize("case", MOE_CASES, ids=_moe_id)
def test_moe_block_takes_the_expert_parallel_path_under_a_mesh(ranks, case):
    _, results = ranks
    for rank in range(WORLD):
        got = results[rank][0][case]
        assert torch.equal(got["block"], got["y"]), rank


def test_moe_block_without_a_mesh_is_dense():
    params, x = _moe_inputs()
    params = {k: torch.tensor(v) for k, v in params.items()}
    cfg = _moe_cfg(1.0)
    x = torch.tensor(x)
    assert torch.equal(moe.moe_block(cfg, params, x),
                       moe.moe_dense(cfg, params, x))


# --- (d) the compressed all-reduce ------------------------------------------

@pytest.mark.parametrize("case", COMP_CASES,
                         ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}")
def test_compressed_psum_matches_jax(ranks, case):
    import jax
    import jax.numpy as jnp
    from repro.distributed.compression import compressed_psum as jax_psum
    (_, comp, _), results = ranks
    method, shape = case
    fn = jax.vmap(lambda x, e: jax_psum(x, "i", e, method=method),
                  axis_name="i")
    err = jnp.zeros((WORLD,) + shape, jnp.float32)
    for s in range(STEPS):
        sent = np.abs(np.asarray((jnp.asarray(comp[case][s]) + err).astype(
            jnp.bfloat16).astype(jnp.float32))).mean(axis=0)
        mean, err = fn(jnp.asarray(comp[case][s]), err)
        mean, err = np.asarray(mean), np.asarray(err)
        for rank in range(WORLD):
            got_mean, got_err = results[rank][1][case][s]
            assert np.array_equal(got_err.numpy(), err[rank]), (s, rank)
            gap = np.abs(got_mean.numpy() - mean[rank])
            if method == "int8":
                assert gap.max() <= 1e-6, (s, rank)
            else:
                assert np.all(gap <= 2.0 ** -6 * sent), (s, rank)
        err = jnp.asarray(err)


def test_compressed_psum_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="compression"):
        compressed_psum(torch.ones(4), None, method="fp8")


# --- (e) the pipeline --------------------------------------------------------

@pytest.mark.parametrize("rank", range(WORLD))
def test_pipeline_forward_matches_the_jax_sequential_product(ranks, rank):
    import jax.numpy as jnp
    (_, _, (ws, x)), results = ranks
    h = jnp.asarray(x.numpy())
    for s in range(STAGES):
        h = jnp.tanh(h @ jnp.asarray(ws[s].numpy()))
    y, moved = results[rank][2]
    assert np.abs(y.numpy() - np.asarray(h)).max() <= 1e-5
    sent = MICRO * MB * WIDTH * 4 if rank < STAGES - 1 else 0
    assert moved["send/recv"] == sent
    assert moved["broadcast"] == MICRO * MB * WIDTH * 4


# --- (f) the sharding rules --------------------------------------------------

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _jax_mesh(shape, axes):
    from jax.sharding import AbstractMesh
    return AbstractMesh(shape, axes)


@pytest.mark.parametrize("arch", list_archs())
def test_rules_for_equals_the_reference(arch):
    from repro.configs import get_config as jax_config
    from repro.distributed import sharding as jsh
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as psh
    for shape, axes in MESHES:
        pm, jm = pmesh.Mesh(shape, axes), _jax_mesh(shape, axes)
        assert psh.dp_axes(pm) == jsh.dp_axes(jm)
        assert psh.dp_degree(pm) == jsh.dp_degree(jm)
        for mode in ("train", "prefill", "decode"):
            for batch in (None, 1, 512):
                got = psh.rules_for(get_config(arch), pm, mode, batch)
                want = jsh.rules_for(jax_config(arch), jm, mode, batch)
                assert dict(got.rules) == dict(want.rules), (shape, mode,
                                                             batch)


def test_base_and_query_rules_equal_the_reference():
    from repro.common import sharding as jsh
    from repro_torch.common import sharding as psh
    for multi_pod in (False, True):
        for fsdp in (False, True):
            for policy in ("head_tp", "seq_sp"):
                got = psh.base_rules(multi_pod, fsdp=fsdp,
                                     attn_policy=policy)
                want = jsh.base_rules(multi_pod, fsdp=fsdp,
                                      attn_policy=policy)
                assert dict(got.rules) == dict(want.rules)
        assert (dict(psh.query_rules(multi_pod).rules)
                == dict(jsh.query_rules(multi_pod).rules))


def test_query_axis_info_reads_the_active_mesh():
    from repro_torch.common.sharding import (query_axis_info, query_rules,
                                             logical_shard)
    assert query_axis_info() is None
    mesh = pmesh.Mesh((2, 16, 16), ("pod", "data", "model"))
    with use_mesh(mesh, query_rules(multi_pod=True)):
        got = query_axis_info()
        assert got[0] is mesh and got[1:] == (("pod", "data"), 32)
        x = torch.ones(3)
        assert logical_shard(x, "query") is x
    with use_mesh(pmesh.Mesh((1,), ("data",)), query_rules()):
        assert query_axis_info() is None
    assert query_axis_info() is None


def test_production_mesh_needs_its_world(ranks):
    _, results = ranks
    for rank in range(WORLD):
        assert results[rank][3] == ("mesh {'data': 16, 'model': 16} needs "
                                    "256 ranks, the world has 4")


def test_mesh_coordinates_and_lines():
    mesh = pmesh.Mesh((2, 2, 3), ("pod", "data", "model"), rank=7)
    assert mesh.coords == {"pod": 1, "data": 0, "model": 1}
    assert mesh.axis_index(("pod", "data")) == 2
    assert mesh.axis_index("model") == 1 and mesh.axis_size("data") == 2
    assert mesh._lines(("data",)) == [[0, 3], [1, 4], [2, 5], [6, 9],
                                      [7, 10], [8, 11]]
    assert mesh._lines(("pod", "model"))[0] == [0, 1, 2, 6, 7, 8]
    with pytest.raises(ValueError, match="differ"):
        pmesh.Mesh((2, 2), ("data",))


# --- (g) the harness ---------------------------------------------------------

def _raising_rank(rank, world, device, args):
    if rank == 2:
        raise RuntimeError("rank two fails on purpose")
    time.sleep(60)


def _sleeping_rank(rank, world, device, args):
    time.sleep(60)


def _live_ranks(entry):
    """Processes whose command line runs this entry."""
    found = []
    for p in Path("/proc").iterdir():
        if not p.name.isdigit():
            continue
        try:
            cmd = (p / "cmdline").read_bytes().replace(b"\0", b" ")
        except OSError:
            continue
        if b"repro_torch.launch.mesh" in cmd and entry.encode() in cmd:
            found.append(int(p.name))
    return found


@pytest.mark.parametrize("name", ["_raising_rank", "_sleeping_rank"])
def test_run_ranks_kills_the_group_and_raises(name):
    entry = f"{__file__}:{name}"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        pmesh.run_ranks(entry, WORLD, backend="gloo", device="cpu",
                        timeout=3.0 if name == "_sleeping_rank" else TIMEOUT)
    if name == "_raising_rank":
        assert "rank two fails on purpose" in str(err.value)
        assert "rank 2 exited" in str(err.value)
    else:
        assert "timed out after 3 s" in str(err.value)
        assert time.monotonic() - t0 < 30
    assert _live_ranks(entry) == []


def test_run_ranks_refuses_other_backends():
    with pytest.raises(ValueError, match="gloo"):
        pmesh.run_ranks("x:y", 2, backend="nccl", device="cuda", timeout=1)
