"""The port's analysis plane against the JAX package and PERF.md.

- ``roofline``: ``roofline_terms`` equal the reference's once its TPU v5e
  constants are swapped for the H100's; ``model_flops`` equal;
- ``models.zoo``: ``input_shapes`` (meta tensors) leaf for leaf against
  the reference's ``jax.eval_shape`` structs, and ``param_count_estimate``,
  for the ten configurations x the four SHAPES; ``concrete_inputs`` gives
  the reference's shapes and dtypes at small sizes;
- ``analytic.memory_term``: the bytes of the reference's ``memory_term``
  on a one-device mesh (its rules from ``repro.distributed.sharding.
  rules_for``, the port's from its own) within 1e-12 relative, for the ten
  x four cells, with the launcher's full ``TrainConfig`` in the train
  cell; the per-device terms (``params_bytes_per_device``,
  ``cache_bytes_per_device``, ``activation_bytes_per_device``,
  ``memory_term``) on shape-only meshes (16, 16) and (2, 16, 16), the
  reference's an ``AbstractMesh``, within 1e-12 relative;
- ``kernel_work``: PERF.md's kernel-table bounds (NVIDIA H100 80GB HBM3,
  700 W constants): row 2 at the route batch, row 9 at danube's and
  hymba's heads, row 9b at danube's and L2's dense floor;
- ``profiler``: a known function read with CPU activity.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.analysis import analytic as jax_analytic  # noqa: E402
from repro.analysis import roofline as jax_roofline  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.distributed.sharding import rules_for  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import zoo as jax_zoo  # noqa: E402
from repro_torch.analysis import (analytic, kernel_work, profiler,  # noqa: E402
                                  roofline)
from repro_torch.configs import (SHAPES, get_config, get_smoke_config,  # noqa: E402
                                 list_archs)
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    rules_for as port_rules_for)
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import build_model, zoo  # noqa: E402

ARCHS = list_archs()
DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
          torch.int32: jnp.int32, torch.int8: jnp.int8}
# the launcher's TrainConfig at full size (repro_torch.launch.train)
LAUNCH_TCFG = TrainConfig(microbatches=8, moment_dtype="int8")


def test_ten_configurations():
    assert len(ARCHS) == 10


def _leaves(tree):
    """Leaves in JAX's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("flops,nbytes,coll", [
    (3.2e15, 1.1e12, 0.0), (1e12, 8e12, 2e10), (0.0, 0.0, 0.0),
    (5e13, 1e9, 7e11)])
def test_roofline_terms_match_the_reference(monkeypatch, flops, nbytes, coll):
    monkeypatch.setattr(jax_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jax_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jax_roofline, "ICI_BW", roofline.LINK_BW)
    assert roofline.roofline_terms(flops, nbytes, coll) == \
        jax_roofline.roofline_terms(flops, nbytes, coll)
    for training in (True, False):
        assert roofline.model_flops(3_962_000_000, 32_768,
                                    training=training) == \
            jax_roofline.model_flops(3_962_000_000, 32_768,
                                     training=training)


def test_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.PEAK_TF32, roofline.PEAK_FP32,
            roofline.HBM_BW, roofline.LINK_BW) == (989e12, 495e12, 67e12,
                                                   3.35e12, 450e9)
    assert roofline.bound_ms(989e9, 1.0, roofline.PEAK_FLOPS) == \
        pytest.approx(1.0)
    assert roofline.bound_by(1.0, 3.35e9) == "bytes"


@pytest.mark.parametrize("arch", ARCHS)
def test_input_shapes_and_param_count_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert zoo.param_count_estimate(cfg) == jax_zoo.param_count_estimate(jcfg)
    for name, shape in SHAPES.items():
        got = zoo.input_shapes(cfg, shape)
        want = jax_zoo.input_shapes(jcfg, shape)
        assert list(got) == zoo.input_shapes_keys(cfg, shape) == \
            jax_zoo.input_shapes_keys(jcfg, shape)
        g, w = _leaves(got), jax.tree.leaves(want)
        assert len(g) == len(w), (name, len(g), len(w))
        for a, b in zip(g, w):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape), name
            assert DTYPES[a.dtype] == b.dtype, (name, a.dtype, b.dtype)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "phi-3-vision-4.2b",
                                  "seamless-m4t-large-v2", "hymba-1.5b"])
def test_concrete_inputs_match_the_reference_shapes(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    for name in ("train_4k", "decode_32k"):
        gen = torch.Generator().manual_seed(0)
        got = zoo.concrete_inputs(cfg, SHAPES[name], gen, batch_override=2,
                                  seq_override=16)
        want = jax_zoo.concrete_inputs(jcfg, SHAPES[name],
                                       jax.random.PRNGKey(0),
                                       batch_override=2, seq_override=16)
        assert sorted(got) == sorted(want)
        for key in got:
            if key == "cache":
                assert got[key]["pos"] == int(want[key]["pos"]) == 8
                g = _leaves(got[key]["segs"])
                w = jax.tree.leaves(want[key]["segs"])
            else:
                g, w = [got[key]], [want[key]]
            for a, b in zip(g, w, strict=True):
                assert tuple(a.shape) == tuple(b.shape)
                assert DTYPES[a.dtype] == b.dtype
        again = zoo.concrete_inputs(cfg, SHAPES[name],
                                    torch.Generator().manual_seed(0),
                                    batch_override=2, seq_override=16)
        key = "tokens" if name == "train_4k" else "token"
        assert torch.equal(got[key], again[key])
        assert 0 <= int(got[key].min()) <= int(got[key].max()) < \
            cfg.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_term_matches_the_reference_on_one_device(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh = make_host_mesh(1, 1)
    pmesh = Mesh((1, 1), ("data", "model"))
    decls, jdecls = build_model(cfg).decls(), jax_build(jcfg).decls()
    jtcfg = jax_analytic.TrainConfig(microbatches=LAUNCH_TCFG.microbatches,
                                     moment_dtype=LAUNCH_TCFG.moment_dtype)
    for name, shape in SHAPES.items():
        rules = rules_for(jcfg, mesh, shape.kind,
                          global_batch=shape.global_batch)
        prules = port_rules_for(cfg, pmesh, shape.kind,
                                global_batch=shape.global_batch)
        cache = specs = jcache = jspecs = None
        if shape.is_decode:
            cache = zoo.input_shapes(cfg, shape)["cache"]
            specs = zoo.cache_specs(cache, prules)
            jcache = jax_zoo.input_shapes(jcfg, shape)["cache"]
            jspecs = jax_zoo.cache_specs(jcache, rules)
        train = shape.kind == "train"
        got = analytic.memory_term(cfg, shape, pmesh, prules, decls, cache,
                                   specs, LAUNCH_TCFG if train else None)
        want = jax_analytic.memory_term(jcfg, shape, mesh, rules, jdecls,
                                        jcache, jspecs,
                                        jtcfg if train else None)
        assert set(got) == set(want)
        for key in ("params_bytes_pd", "cache_bytes_pd",
                    "activation_bytes_pd", "memory_bytes_pd"):
            assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), \
                (name, key)
        assert got["memory_s"] == pytest.approx(
            got["memory_bytes_pd"] / roofline.HBM_BW, rel=1e-15)


# the production meshes: (16, 16) over (data, model) and (2, 16, 16) over
# (pod, data, model); the reference reads only their shape and axis names
PROD_MESHES = (((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_shape", PROD_MESHES,
                         ids=["16x16", "2x16x16"])
def test_per_device_terms_match_the_reference(arch, mesh_shape):
    """``params_bytes_per_device``, ``cache_bytes_per_device``,
    ``activation_bytes_per_device`` and ``memory_term`` against the
    reference's on a shape-only mesh (``AbstractMesh`` there), for the four
    SHAPES under ``rules_for`` of each one's mode, within 1e-12
    relative."""
    from jax.sharding import AbstractMesh
    cfg, jcfg = get_config(arch), jax_config(arch)
    jmesh, pmesh = AbstractMesh(*mesh_shape), Mesh(*mesh_shape)
    decls, jdecls = build_model(cfg).decls(), jax_build(jcfg).decls()
    jtcfg = jax_analytic.TrainConfig(microbatches=LAUNCH_TCFG.microbatches,
                                     moment_dtype=LAUNCH_TCFG.moment_dtype)
    for name, shape in SHAPES.items():
        rules = rules_for(jcfg, jmesh, shape.kind,
                          global_batch=shape.global_batch)
        prules = port_rules_for(cfg, pmesh, shape.kind,
                                global_batch=shape.global_batch)
        pairs = [(analytic.params_bytes_per_device(decls, prules, pmesh),
                  jax_analytic.params_bytes_per_device(jdecls, rules, jmesh)),
                 (analytic.activation_bytes_per_device(cfg, shape, pmesh),
                  jax_analytic.activation_bytes_per_device(jcfg, shape,
                                                           jmesh))]
        cache = specs = jcache = jspecs = None
        if shape.is_decode:
            cache = zoo.input_shapes(cfg, shape)["cache"]
            specs = zoo.cache_specs(cache, prules)
            jcache = jax_zoo.input_shapes(jcfg, shape)["cache"]
            jspecs = jax_zoo.cache_specs(jcache, rules)
            pairs.append((analytic.cache_bytes_per_device(cache, specs,
                                                          pmesh),
                          jax_analytic.cache_bytes_per_device(jcache, jspecs,
                                                              jmesh)))
        train = shape.kind == "train"
        got = analytic.memory_term(cfg, shape, pmesh, prules, decls, cache,
                                   specs, LAUNCH_TCFG if train else None)
        want = jax_analytic.memory_term(jcfg, shape, jmesh, rules, jdecls,
                                        jcache, jspecs,
                                        jtcfg if train else None)
        pairs += [(got[k], want[k]) for k in sorted(want)
                  if k != "memory_s"]
        for i, (a, b) in enumerate(pairs):
            assert a == pytest.approx(b, rel=1e-12, abs=0), (name, i)


def test_kernel_work_reproduces_the_kernel_table_bounds():
    # row 2: the retrieval vote at the route batch (3xTF32 and float32)
    fp32_ms, tf32_ms = kernel_work.retrieval_bounds(16_384, 131_072, 256, 8,
                                                    6)
    assert round(tf32_ms, 3) == 6.664 and round(fp32_ms, 3) == 16.411
    # row 9: the flash forward at danube's heads (D 120) and hymba's (D 64)
    nbytes, nops = kernel_work.flash_forward(16, 1535, 1535, 32, 8, 120,
                                             4096, 0, 2)
    assert round(roofline.bound_ms(nops, nbytes, kernel_work.peak_for(2)),
                  4) == 0.2929
    assert roofline.bound_by(nops, nbytes, roofline.PEAK_FLOPS) == \
        "operations"
    nbytes, nops = kernel_work.flash_forward(16, 1500, 1500, 25, 5, 64,
                                             1024, 0, 2)
    assert round(nops / 1e9, 2) == 103.65
    assert round(roofline.bound_ms(nops, nbytes, roofline.PEAK_FLOPS),
                 4) == 0.1048
    # row 9b: the flash backward at danube's heads, B 1, S 4,096
    nbytes, nops = kernel_work.flash_backward(1, 4096, 4096, 32, 8, 120,
                                              4096, 0, 2)
    assert round(nops / 1e9, 2) == 322.20
    assert round(roofline.bound_ms(nops, nbytes, roofline.PEAK_FLOPS),
                 4) == 0.3258
    # L2's dense floor: 3.962 B parameters, 8 x 4,096 tokens
    assert round(kernel_work.train_floor_s(3.962e9, 8 * 4096), 3) == 1.050
    # row 6's bytes: the paged decode at 60.89 MB is bytes-bound
    lens = np.linspace(345, 1501, 16).astype(np.int64)
    nbytes, nops = kernel_work.decode_attention(lens, 32, 8, 120, 4096, 2,
                                                16 * 128)
    ms, by = kernel_work.attention_bound(nbytes, nops, 2)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_kernel_work_counts_only_this_calls_work():
    """A window or a causal mask cuts the visible pairs; padded rows and
    an early stop cut the solve's operations."""
    full = kernel_work.flash_forward(1, 512, 512, 4, 4, 64, 0, 0, 2,
                                     causal=False)[1]
    causal = kernel_work.flash_forward(1, 512, 512, 4, 4, 64, 0, 0, 2)[1]
    windowed = kernel_work.flash_forward(1, 512, 512, 4, 4, 64, 128, 0, 2)[1]
    assert full == 4.0 * 64 * 4 * 512 * 512
    assert causal == 4.0 * 64 * 4 * 512 * 513 / 2
    assert windowed < causal
    assert kernel_work.dual_solve(1000, 6, 10)[1] == 10 * 1000 * 25
    assert kernel_work.blocked_ascent(700, 1024, 6, 10)[1] == 10 * 700 * 25
    nb, no = kernel_work.decode_attention([5, 0, 3000], 8, 2, 16, 1024, 2)
    assert no == 4.0 * (5 + 1024) * 8 * 16
    nb_v, no_v = kernel_work.verify_attention([5, 10], 3, 8, 2, 16, 0, 2, 4)
    assert no_v == 4.0 * (5 + 6 + 7 + 10 + 11 + 12) * 8 * 16
    assert nb_v == 2 * 2 * 3 * 8 * 16 * 2 + 2 * (7 + 12) * 2 * 16 * 2 + 16 + 8


def test_profiler_reads_a_known_function_on_the_cpu():
    a = torch.randn(64, 64)

    def fn():
        for _ in range(3):
            torch.mm(a, a)
        for _ in range(2):
            torch.add(a, a)

    prof = profiler.profile(fn, device="cpu")
    assert prof.kernels["aten::mm"][1] == 3
    assert prof.kernels["aten::add"][1] == 2
    assert prof.launches("aten::mm", "aten::add") == 5
    assert 0 < prof.busy_share <= 1
    assert prof.ms("aten::mm") > 0 and prof.total_ms >= prof.ms("aten::mm")
    assert prof.top(1)[0][0] == "aten::mm" or prof.top(1)[0][1] > 0
    assert profiler._union_us([(0, 2), (1, 3), (5, 6)]) == 4
