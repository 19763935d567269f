"""The port's checkpointer against the JAX package's, and resume.

A checkpoint is one ``.npz`` of every leaf keyed by its tree path as
``jax.tree_util`` spells it, plus a ``.json`` manifest; bf16 leaves as
their ``uint16`` bits.  A training state written by the JAX
``Checkpointer`` (bf16 parameters, int8 ``QTensor`` or bf16 moments,
after a step) restores into the port's state with equal leaves, and one
written by the port restores into JAX's; the files hold the same keys,
shapes and dtypes.  Async saves, ``keep`` and ``latest_step``; restoring
onto the like tree's device and dtype; and a launcher run resumed from its
step-3 checkpoint equal, bit for bit, to the uninterrupted run on the
CPU.  The elastic re-mesh in one process: the reference's 8 x 8 case,
saved under (2, 4) and restored under (4, 2) on shape-only meshes, every
coordinate's block bit for bit (the sharded save itself runs on ranks in
``tests/test_torch_sharded_train.py``).
"""
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.data.pipeline import synthetic_batches as jax_batches  # noqa: E402
from repro.ft.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training import Trainer as JaxTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.ft.checkpoint import Checkpointer  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import QTensor, Trainer, tree_leaves  # noqa: E402

ARCH = "h2o-danube-3-4b"


def _jax_state(moments):
    """A JAX Trainer state after one step: bf16 parameters, moments of
    ``moments``."""
    jc = jax_smoke(ARCH)
    jt = JaxTrainer(jax_build(jc), JaxTrainConfig(microbatches=1,
                                                  moment_dtype=moments))
    js = jt.init_state(jax.random.PRNGKey(2))
    b = next(jax_batches(jc, JaxShape("t", 16, 2, "train")))
    js, _ = jax.jit(jt.train_step)(js, {k: jnp.asarray(v)
                                        for k, v in b.items()})
    return jt, js


def _port_like(moments):
    """A zeroed port state of the same structure (another seed)."""
    pt = Trainer(build_model(get_smoke_config(ARCH)),
                 TrainConfig(microbatches=1, moment_dtype=moments))
    return pt.init_state(5, "cpu")


def _numpy_leaves(tree):
    """Leaves as float NumPy (bf16 widened exactly), port or JAX."""
    out = []
    for leaf in tree_leaves(tree) if not _is_jax(tree) else \
            jax.tree.leaves(tree):
        if isinstance(leaf, QTensor):
            out += [np.asarray(leaf.q.float()), np.asarray(leaf.scale)]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf.float().numpy())
        elif isinstance(leaf, int):
            out.append(np.asarray(leaf, np.float32))
        else:
            out.append(np.asarray(leaf, np.float32))
    return out


def _is_jax(tree):
    return isinstance(jax.tree.leaves(tree)[0], jax.Array)


@pytest.mark.parametrize("moments", ["int8", "bf16"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, moments):
    _, js = _jax_state(moments)
    JaxCheckpointer(str(tmp_path)).save(1, js, blocking=True)
    like = _port_like(moments)
    state, step = Checkpointer(str(tmp_path)).restore(like)
    assert step == 1 and state["opt"]["step"] == 1
    assert state["params"]["embed"].dtype == torch.bfloat16
    if moments == "int8":
        m = tree_leaves(state["opt"]["m"])[0]
        assert isinstance(m, QTensor) and m.q.dtype == torch.int8
    got, want = _numpy_leaves(state), _numpy_leaves(js)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("moments", ["int8", "fp32"])
def test_port_checkpoint_restores_into_jax(tmp_path, moments):
    jt, js = _jax_state(moments)
    port = convert.train_state_from_numpy(
        get_smoke_config(ARCH), TrainConfig(moment_dtype=moments),
        jax.tree.map(np.asarray, js), "cpu")
    Checkpointer(str(tmp_path / "port")).save(1, port, blocking=True)
    JaxCheckpointer(str(tmp_path / "jax")).save(1, js, blocking=True)
    like = jt.init_state(jax.random.PRNGKey(9))
    restored, step = JaxCheckpointer(str(tmp_path / "port")).restore(like)
    assert step == 1
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))
    # the two packages write the same keys, shapes and dtypes
    mp, mj = (json.loads((tmp_path / d / "ckpt_00000001.json").read_text())
              for d in ("port", "jax"))
    assert mp == mj


def test_async_save_keep_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({"w": torch.zeros(2)})
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "n": [torch.ones(3), 7]}
    for step in (1, 2, 3):
        tree["w"] = tree["w"] + 1
        ck.save(step, tree)                 # async
    ck.wait()
    assert ck.list_steps() == [2, 3] and ck.latest_step() == 3
    like = {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
            "n": [torch.zeros(3, dtype=torch.float64), 0]}
    got, step = ck.restore(like)
    assert step == 3
    assert torch.equal(got["w"], tree["w"])
    assert got["n"][0].dtype == torch.float64
    assert torch.equal(got["n"][0], torch.ones(3, dtype=torch.float64))
    assert got["n"][1] == 7
    old, _ = ck.restore(like, step=2)
    assert torch.equal(old["w"], tree["w"] - 1)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    common = ["--arch", ARCH, "--smoke", "--ckpt-every", "3", "--device",
              "cpu"]
    full = tmp_path / "full"
    last = launcher.main(common + ["--steps", "6", "--ckpt-dir", str(full)])
    part = tmp_path / "part"
    part.mkdir()
    for ext in (".npz", ".json"):
        shutil.copy(full / f"ckpt_00000003{ext}", part)
    resumed = launcher.main(common + ["--steps", "6", "--ckpt-dir",
                                      str(part), "--resume"])
    assert resumed == last
    a = np.load(full / "ckpt_00000006.npz")
    b = np.load(part / "ckpt_00000006.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_elastic_remesh_restores_every_block(tmp_path, writer):
    """The reference's re-mesh case (``tests/test_distributed.py::
    test_elastic_checkpoint_remesh``): an 8 x 8 ``arange`` sharded
    ``("data", "model")`` over a (2, 4) mesh is saved (the file a sharded
    save writes: its blocks gathered whole), then restored under (4, 2);
    on shape-only meshes, each of the eight coordinates keeps exactly its
    block, bit for bit, from the port's file and from JAX's."""
    from repro_torch.common.params import local_block
    from repro_torch.launch.mesh import Mesh
    axes, spec = ("data", "model"), ("data", "model")
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    saved = [local_block(w, spec, Mesh((2, 4), axes, rank=r))
             for r in range(8)]
    whole = torch.cat([torch.cat(saved[i * 4:(i + 1) * 4], dim=1)
                       for i in range(2)], dim=0)
    assert torch.equal(whole, w)
    if writer == "port":
        Checkpointer(str(tmp_path)).save(1, {"w": whole}, blocking=True)
    else:
        JaxCheckpointer(str(tmp_path)).save(
            1, {"w": jnp.asarray(whole.numpy())}, blocking=True)
    ck = Checkpointer(str(tmp_path))
    for r in range(8):
        mesh = Mesh((4, 2), axes, rank=r)
        like = {"w": torch.zeros((2, 4), dtype=torch.float32)}
        got, step = ck.restore(like, specs={"w": spec}, mesh=mesh)
        d, m = mesh.coords["data"], mesh.coords["model"]
        assert step == 1 and got["w"].shape == (2, 4)
        assert torch.equal(got["w"], w[2 * d:2 * d + 2, 4 * m:4 * m + 4])
