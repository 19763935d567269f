"""Package boundary of the PyTorch port (``src/repro_torch``).

The port imports neither ``jax`` nor anything of the JAX package ``repro``:
a subprocess imports every module of the port and checks ``sys.modules``,
and a source scan finds no such import in the port or in ``chip_smoke.py``.
The plain-Python and NumPy leaves the port copies (tokenizer, SynthQAServe,
baselines (S3 over one predictor tree in both), the featurizer
projection, the arch configs, the layer plan, ``route_via_batch``, the
admission rule, the arrival processes, the health tracker, the fault
plans and the synthetic training batches) must equal their originals
exactly — same token ids, same dataset, same projection bits, same config
values, same plans, same routes, same arrival times, same breaker states,
same fault answers, the same generator — and the sanitizer plane's NumPy
members (PageSan, LedgerSan, SolveCert) and the training health monitor
are byte-for-byte copies of theirs.  A
scan of the CUDA sources finds no library kernel (cuBLAS, cuDNN,
CUTLASS's device- or kernel-level GEMMs).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)


def test_import_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "print(len(names), bad)\n"
        "need = {'repro_torch.core.speculative', 'repro_torch.core.control',\n"
        "        'repro_torch.core.scheduler', 'repro_torch.core.health',\n"
        "        'repro_torch.data.arrivals', 'repro_torch.serving.faults',\n"
        "        'repro_torch.serving.engine',\n"
        "        'repro_torch.training.optim',\n"
        "        'repro_torch.kernels.decode_attention.ops',\n"
        "        'repro_torch.kernels.flash_attention.ops',\n"
        "        'repro_torch.kernels.flash_attention.kernel',\n"
        "        'repro_torch.kernels.flash_attention.ref',\n"
        "        'repro_torch.models.zoo', 'repro_torch.models.moe',\n"
        "        'repro_torch.models.encdec',\n"
        "        'repro_torch.common.guards',\n"
        "        'repro_torch.analysis.sanitize',\n"
        "        'repro_torch.analysis.sanitize.racecheck',\n"
        "        'repro_torch.kernels.lagrangian_assign.ops',\n"
        "        'repro_torch.training.train_step',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.ft.checkpoint',\n"
        "        'repro_torch.ft.health', 'repro_torch.launch.train',\n"
        "        'repro_torch.launch.serve', 'repro_torch.analysis.roofline',\n"
        "        'repro_torch.analysis.analytic',\n"
        "        'repro_torch.analysis.kernel_work',\n"
        "        'repro_torch.analysis.profiler',\n"
        "        'repro_torch.analysis.staticcheck',\n"
        "        'repro_torch.analysis.staticcheck.callgraph',\n"
        "        'repro_torch.analysis.staticcheck.core',\n"
        "        'repro_torch.analysis.staticcheck.rules',\n"
        "        'repro_torch.analysis.staticcheck.__main__',\n"
        "        'repro_torch.launch.mesh', 'repro_torch.common.sharding',\n"
        "        'repro_torch.distributed.sharding',\n"
        "        'repro_torch.distributed.compression',\n"
        "        'repro_torch.distributed.pipeline',\n"
        "        'repro_torch.training.sharded', 'repro_torch.common.params',\n"
        "        'repro_torch.kernels.decode_attention.kernel',\n"
        "        'repro_torch.kernels.decode_attention.ref'}\n"
        "sys.exit(1 if bad or len(names) < 15 or need - set(names) else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_source_scan_finds_no_jax_or_reference_import():
    files = _port_sources()
    assert len(files) > 15
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files
                 for m in _FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("rel", ["src/repro_torch/models/moe.py",
                                 "src/repro_torch/models/encdec.py",
                                 "chip_smoke.py"])
def test_source_scan_covers_the_model_families(rel):
    """The MoE FFN, the encoder-decoder and ``chip_smoke.py`` are among
    the scanned sources, and none imports ``jax`` or ``repro``."""
    path = ROOT / rel
    assert path in _port_sources()
    assert not _FORBIDDEN.search(path.read_text())


@pytest.mark.parametrize("rel", ["src/repro_torch/training/train_step.py",
                                 "src/repro_torch/data/pipeline.py",
                                 "src/repro_torch/ft/checkpoint.py",
                                 "src/repro_torch/ft/health.py",
                                 "src/repro_torch/launch/train.py"])
def test_source_scan_covers_the_training_path(rel):
    """The trainer, the data pipeline, the checkpointer, the health
    monitor and the launcher are among the scanned sources, and none
    imports ``jax`` or ``repro``."""
    path = ROOT / rel
    assert path in _port_sources()
    assert not _FORBIDDEN.search(path.read_text())


@pytest.mark.parametrize("rel", [
    "src/repro_torch/launch/serve.py", "src/repro_torch/models/zoo.py",
    "src/repro_torch/analysis/roofline.py",
    "src/repro_torch/analysis/analytic.py",
    "src/repro_torch/analysis/kernel_work.py",
    "src/repro_torch/analysis/profiler.py",
    "src/repro_torch/analysis/staticcheck/__init__.py",
    "src/repro_torch/analysis/staticcheck/__main__.py",
    "src/repro_torch/analysis/staticcheck/callgraph.py",
    "src/repro_torch/analysis/staticcheck/core.py",
    "src/repro_torch/analysis/staticcheck/rules.py"])
def test_source_scan_covers_the_launcher_and_analysis(rel):
    """The serving launcher, the zoo's input helpers, the analysis plane
    and the staticcheck twin are among the scanned sources, and none
    imports ``jax`` or ``repro``."""
    path = ROOT / rel
    assert path in _port_sources()
    assert not _FORBIDDEN.search(path.read_text())


@pytest.mark.parametrize("rel", [
    "src/repro_torch/launch/mesh.py", "src/repro_torch/common/sharding.py",
    "src/repro_torch/distributed/__init__.py",
    "src/repro_torch/distributed/sharding.py",
    "src/repro_torch/distributed/compression.py",
    "src/repro_torch/distributed/pipeline.py",
    "src/repro_torch/training/sharded.py", "src/repro_torch/common/params.py",
    "src/repro_torch/training/optim.py",
    "src/repro_torch/kernels/decode_attention/ops.py",
    "src/repro_torch/kernels/decode_attention/kernel.py",
    "src/repro_torch/kernels/decode_attention/ref.py"])
def test_source_scan_covers_the_distribution_plane(rel):
    """The rank harness and mesh, the sharding rules, the compressed
    all-reduce, the pipeline, the sharded train step with its parameter
    specs and optimizer, and the sequence-sharded decode are among the
    scanned sources, and none imports ``jax`` or ``repro``."""
    path = ROOT / rel
    assert path in _port_sources()
    assert not _FORBIDDEN.search(path.read_text())


@pytest.mark.parametrize("rel", [
    "src/repro_torch/models/layers.py", "src/repro_torch/models/attention.py",
    "src/repro_torch/models/transformer.py",
    "src/repro_torch/kernels/flash_attention/ops.py",
    "src/repro_torch/ft/checkpoint.py", "src/repro_torch/models/moe.py",
    "src/repro_torch/training/sharded.py"])
def test_source_scan_covers_promotion_remesh_and_moe_step(rel):
    """The modules that promote mixed dtypes as JAX does (C16), the
    checkpointer's re-mesh and the MoE family's sharded step are among
    the scanned sources, and none imports ``jax`` or ``repro``."""
    path = ROOT / rel
    assert path in _port_sources()
    assert not _FORBIDDEN.search(path.read_text())


def test_source_scan_pattern_catches_imports():
    """The scan itself: it flags real imports and passes the port's own."""
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "  from repro.core import y", "import repro"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import z",
               "# see repro.core.optimizer"):
        assert not _FORBIDDEN.search(ok), ok


# a library's kernels in a CUDA source: cuBLAS, cuDNN, or CUTLASS's
# device- or kernel-level GEMMs (its building blocks stay allowed)
_LIBRARY_KERNEL = re.compile(
    r"cublas|cudnn|cutlass/gemm/(device|kernel)/", re.I)


def test_csrc_scan_finds_no_library_kernel():
    """Every kernel of the port is written by hand."""
    files = sorted((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu*"))
    assert len(files) >= 5
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0)}" for p in files
                 for m in _LIBRARY_KERNEL.finditer(p.read_text())]
    assert not offenders, offenders


def test_csrc_scan_pattern_catches_library_kernels():
    for bad in ("#include <cublas_v2.h>", "cublasSgemm(h, ...)",
                "#include <cudnn.h>",
                "#include \"cutlass/gemm/device/gemm.h\"",
                "#include <cutlass/gemm/kernel/default_gemm.h>"):
        assert _LIBRARY_KERNEL.search(bad), bad
    for ok in ("#include <cuda_runtime.h>", "mma.sync.aligned.m16n8k8",
               "#include <cutlass/arch/mma_sm80.h>"):
        assert not _LIBRARY_KERNEL.search(ok), ok


def test_library_tag_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared header (``csrc/*.cuh``) gives every library a
    new name, so no stale build of an including source is loaded."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setitem(_build.FLAGS, "k", ["-O3"])
    before = _build._target("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("k") != before
    (tmp_path / "h.cuh").write_text("// one\n")
    assert _build._target("k") == before


@pytest.mark.parametrize("member", ["pagesan", "ledgersan", "solvecert"])
def test_sanitizer_copies_are_byte_identical(member):
    """The sanitizer plane's NumPy members are the reference's files as
    they are: their relative ``from . import counters`` resolves to the
    port's own plane."""
    rel = Path("analysis") / "sanitize" / f"{member}.py"
    port = (ROOT / "src" / "repro_torch" / rel).read_bytes()
    assert port == (ROOT / "src" / "repro" / rel).read_bytes()
    assert not _FORBIDDEN.search(port.decode())


def test_health_monitor_copy_is_byte_identical():
    """The training loop's heartbeat and straggler monitor is the
    reference's file as it is (standard library only)."""
    rel = Path("ft") / "health.py"
    port = (ROOT / "src" / "repro_torch" / rel).read_bytes()
    assert port == (ROOT / "src" / "repro" / rel).read_bytes()
    assert not _FORBIDDEN.search(port.decode())


def test_synthetic_batches_copy_is_identical():
    """The training batches' generator is the reference's function as it
    is: the same source, so the same batches from the same seed."""
    import inspect
    from repro.data import pipeline as ref_pipe
    from repro_torch.data import pipeline as port_pipe
    assert (inspect.getsource(port_pipe.synthetic_batches)
            == inspect.getsource(ref_pipe.synthetic_batches))


@pytest.mark.parametrize("max_len", [48, 64])
def test_tokenizer_copy_is_bit_identical(max_len):
    from repro.data import tokenizer as ref_tok
    from repro.data.qaserve import generate
    from repro_torch.data import tokenizer as port_tok
    texts = generate(n=300, seed=0).queries + ["", "Mixed CASE words", "a " * 90]
    assert port_tok.VOCAB == ref_tok.VOCAB
    assert (port_tok.PAD, port_tok.CLS) == (ref_tok.PAD, ref_tok.CLS)
    got = port_tok.encode_batch(texts, max_len)
    want = ref_tok.encode_batch(texts, max_len)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_qaserve_copy_generates_the_same_dataset():
    from repro.data import qaserve as ref_q
    from repro_torch.data import qaserve as port_q
    a, b = port_q.generate(n=300, seed=0), ref_q.generate(n=300, seed=0)
    assert a.queries == b.queries
    for field in ("task", "difficulty", "input_len", "correct", "out_len",
                  "topic"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert [p.name for p in a.pool] == [p.name for p in b.pool]
    assert np.array_equal(a.cost_matrix(), b.cost_matrix())
    assert port_q.L_MAX == ref_q.L_MAX
    assert np.array_equal(port_q.bucketize(a.out_len, 10),
                          ref_q.bucketize(b.out_len, 10))
    for (sa, sb) in zip(a.split(), b.split()):
        assert sa.queries == sb.queries


def test_projection_copy_is_bit_identical():
    from repro.core.features import projection_np as ref_proj
    from repro_torch.core.features import projection, projection_np
    got, want = projection_np(64, 3), ref_proj(64, 3)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # the device copy rounds to float32 exactly as jnp.asarray does
    assert np.array_equal(projection(64, 3, "cpu").numpy(),
                          want.astype(np.float32))


def _s3_pair(m):
    """S3 in both packages over one predictor tree: the JAX initial
    parameters at narrow widths (predictions within ~1e-6, no near-tie
    between a query's two cheapest models in this batch)."""
    import jax
    from repro.common import init_params
    import repro.core as ref_core
    import repro_torch.core as port_core
    from repro_torch import convert
    kw = dict(n_models=m, max_len=16, d_model=32, d_ff=64)
    ref_pred = ref_core.TrainedPredictor(ref_core.PredictorConfig(**kw))
    ref_pred.params = init_params(ref_core.predictor.predictor_decls(
        ref_pred.cfg), jax.random.PRNGKey(1))
    ref, port = ref_core.S3Cost(), port_core.S3Cost(device="cpu")
    ref.pred = ref_pred
    port.pred = port_core.TrainedPredictor(
        port_core.PredictorConfig(**kw), convert.predictor_params_from_numpy(
            jax.tree.map(np.asarray, ref_pred.params), "cpu"), device="cpu")
    return ref, port


@pytest.mark.parametrize("policy", ["BalanceAware", "RandomPolicy", "Oracle",
                                    "S3Cost"])
def test_baseline_copies_route_the_same(policy):
    import repro.core.baselines as ref_b
    from repro.data.qaserve import generate
    import repro_torch.core.baselines as port_b
    ds = generate(n=120, seed=3)
    loads, counts = np.full(ds.m, 25.0), np.full(ds.m, 2.0)
    rb = ds.route_batch(loads, counts)
    pb = port_b.RouteBatch(rb.queries, rb.input_len, rb.price_in,
                           rb.price_out, rb.loads, rb.counts, rb.cost_true,
                           rb.correct_true)
    if policy == "S3Cost":
        ref, port = _s3_pair(ds.m)
    else:
        ref, port = getattr(ref_b, policy)(), getattr(port_b, policy)()
    got = port.route(pb, rng=np.random.RandomState(0))
    want = ref.route(rb, rng=np.random.RandomState(0))
    assert np.array_equal(got, want)
    assert np.allclose(pb.available, rb.available)


@pytest.mark.parametrize("n,multiple", [(1, 1), (5, 1), (100, 8), (64, 8)])
def test_pad_helpers_match(n, multiple):
    import repro.core.baselines as ref_b
    import repro_torch.core.baselines as port_b
    assert port_b.pad_bucket(n, multiple) == ref_b.pad_bucket(n, multiple)


def _all_configs():
    from repro.configs import list_archs
    return [(arch, smoke) for arch in list_archs() for smoke in (False, True)]


@pytest.mark.parametrize("arch,smoke", _all_configs())
def test_arch_config_copies_hold_the_same_values(arch, smoke):
    import dataclasses as dc
    import repro.configs as ref_c
    import repro_torch.configs as port_c
    get = "get_smoke_config" if smoke else "get_config"
    want = getattr(ref_c, get)(arch)
    got = getattr(port_c, get)(arch)
    for f in dc.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert str(a).split(".")[-1] == np.dtype(b).name, (a, b)
        else:
            assert a == b, f.name
    assert (got.hd, got.padded_vocab, got.q_per_kv) == (
        want.hd, want.padded_vocab, want.q_per_kv)


@pytest.mark.parametrize("arch,smoke", _all_configs())
def test_layer_plan_copy_is_identical(arch, smoke):
    import repro.configs as ref_c
    import repro_torch.configs as port_c
    from repro.models.plan import layer_plan as ref_plan
    from repro.models.plan import plan_layer_count as ref_count
    from repro_torch.models.plan import layer_plan, plan_layer_count
    get = "get_smoke_config" if smoke else "get_config"
    want = ref_plan(getattr(ref_c, get)(arch))
    got = layer_plan(getattr(port_c, get)(arch))

    def flat(plan):
        return [(c, tuple((k.block, k.window, k.is_moe) for k in p))
                for c, p in plan]

    assert flat(got) == flat(want)
    assert plan_layer_count(got) == ref_count(want)


@pytest.mark.parametrize("policy", ["BalanceAware", "Oracle"])
def test_route_via_batch_copy_routes_the_same(policy):
    import repro.core.baselines as ref_b
    from repro.core.scheduler import route_via_batch as ref_route
    from repro.data.qaserve import generate as ref_generate
    import repro_torch.core.baselines as port_b
    from repro_torch.core.scheduler import route_via_batch
    from repro_torch.data.qaserve import generate
    loads, counts = np.full(6, 30.0), np.arange(6.0)
    got = route_via_batch(getattr(port_b, policy)(), generate(n=90, seed=4),
                          loads, counts, rng=np.random.RandomState(1))
    want = ref_route(getattr(ref_b, policy)(), ref_generate(n=90, seed=4),
                     loads, counts, rng=np.random.RandomState(1))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("batch_size,cap,queued,inflight", [
    (0, 16, 40, 3), (5, 16, 2, 0), (0, 3, 9, 1), (4, 12, 10, 7)])
def test_admission_rule_copy_takes_the_same(batch_size, cap, queued,
                                            inflight):
    from repro.core.control import AdmissionRule as RefRule
    from repro_torch.core.control import AdmissionRule
    got = AdmissionRule(batch_size).resolve(cap)
    want = RefRule(batch_size).resolve(cap)
    assert (got.batch_size, got.max_inflight) == (want.batch_size,
                                                  want.max_inflight)
    assert got.take(queued, inflight) == want.take(queued, inflight)


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal", "batch"])
def test_arrivals_copy_gives_the_same_times(kind):
    from repro.data import arrivals as ref_arr
    from repro_torch.data import arrivals as port_arr
    for n, rate, seed in ((1, 16.0, 0), (500, 40.0, 3), (2000, 273.1, 1)):
        got = port_arr.make(kind, n, rate=rate, seed=seed)
        want = ref_arr.make(kind, n, rate=rate, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        for a, b in zip(port_arr.window_slices(got, 0.25),
                        ref_arr.window_slices(want, 0.25)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        port_arr.make("nope", 3)


def test_health_copy_follows_the_same_trace():
    """One seeded trace of outcomes, admits and clock advances: the same
    breaker states, EWMAs, trips and views after every event."""
    from repro.core.health import HealthConfig as RefCfg
    from repro.core.health import HealthTracker as RefTracker
    from repro_torch.core.health import HealthConfig, HealthTracker
    fields = ("breaker_state", "fail_ewma", "lat_ewma", "open_until",
              "probe_inflight", "probe_wins", "events_seen")
    kw = dict(cooldown=2.0, min_events=2, probe_slots=2)
    port, ref = HealthTracker(5, HealthConfig(**kw)), RefTracker(5,
                                                                 RefCfg(**kw))
    rng = np.random.RandomState(0)
    now = 0.0
    for _ in range(600):
        j = int(rng.randint(5))
        ev = rng.rand()
        if ev < 0.6:
            ok = bool(rng.rand() > (0.7 if j < 2 else 0.1))
            lat = float(rng.rand() * (3.0 if j == 4 else 1.0))
            port.record(j, ok, lat if ok else None, now=now)
            ref.record(j, ok, lat if ok else None, now=now)
        elif ev < 0.8:
            port.note_admit(j)
            ref.note_admit(j)
        else:
            now += float(rng.rand())
            port.advance(now)
            ref.advance(now)
        for f in fields:
            a, b = getattr(port, f), getattr(ref, f)
            assert a.dtype == b.dtype and np.array_equal(a, b,
                                                         equal_nan=True), f
        assert port.trips == ref.trips
        assert port.next_wake(now) == ref.next_wake(now)
        loads = np.full(5, 4.0)
        assert np.array_equal(port.effective_loads(loads),
                              ref.effective_loads(loads))
        assert np.array_equal(port.price_multiplier(), ref.price_multiplier())
        assert [port.admissible(i) for i in range(5)] == [
            ref.admissible(i) for i in range(5)]
    assert port.trips > 0


def test_faults_copy_answers_the_same():
    """Every question a plan answers, on a grid of times, keys and salts:
    the same answers, and the same counter increments."""
    from repro.serving import faults as ref_f
    from repro_torch.serving import faults as port_f

    def plan(mod):
        s = mod.FaultSpec
        return mod.FaultPlan({
            0: (s("hard_down", start=1.0, end=3.0),),
            1: (s("error_rate", rate=0.6, start=0.5, end=4.0),
                s("error_rate", rate=0.2)),
            2: (s("latency_spike", start=1.0, factor=3.0),
                s("rate_limit", capacity=2), s("rate_limit", capacity=3,
                                                start=2.0))}, seed=7)

    port, ref = plan(port_f), plan(ref_f)
    port_f.reset_counters()
    ref_f.reset_counters()
    for t in np.arange(0.0, 5.0, 0.25):
        for j in range(4):
            assert port.down(j, t) == ref.down(j, t)
            assert port.down_during(j, t, t + 0.6) == ref.down_during(
                j, t, t + 0.6)
            assert port.latency_factor(j, t) == ref.latency_factor(j, t)
            assert port.rate_limit(j, t) == ref.rate_limit(j, t)
            for key in range(6):
                for salt in range(3):
                    assert port.flake(j, t, key, salt) == ref.flake(
                        j, t, key, salt)
    assert port_f.counters == ref_f.counters
    assert port_f.counters["injected"] > 0
    with pytest.raises(ValueError):
        port_f.FaultSpec("nope")
