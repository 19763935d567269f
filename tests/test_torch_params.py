"""The port's parameter declarations and their specs against the JAX
package (declarations only: nothing of full size is allocated).

- C15: in a float32 configuration the reference's ``ParamDecl`` keeps its
  bf16 default, so its init is bf16 but for the leaves it declares float32
  (hymba's five, the mLSTM's ``w_gates``, the MoE router).  The port's
  init equals it leaf for leaf: the keys, shapes, dtypes and logical axes
  of every declaration, and the dtypes of what ``init`` draws (the
  reference's through ``jax.eval_shape``); ``hidden`` on that init returns
  the reference's dtype (bf16) in the nine configurations whose input is
  tokens.  ``convert.model_params_from_numpy`` gives float32 leaves in a
  float32 configuration and ``common.cast_tree`` casts an init the same
  way.
- The specs: ``param_specs``, ``Trainer.state_specs`` (fp32 and int8
  moments), ``zoo.input_logical`` and ``zoo.cache_specs`` under
  ``rules_for`` in train, prefill and decode on meshes (2, 4), (4, 2) and
  (1, 4), equal to the reference's PartitionSpecs for all ten
  configurations (a one-axis tuple entry compares equal to its axis name,
  as JAX normalises it).
- ``Trainer.abstract_state`` and ``tree_bytes`` against the reference's
  ``abstract_state`` (shapes, dtypes, bytes), and ``shard_tree``'s blocks,
  laid side by side over every rank of a mesh, against the whole tree.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.distributed.sharding import rules_for as jax_rules  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.zoo import input_logical as jax_input_logical  # noqa: E402
from repro.training import Trainer as JaxTrainer  # noqa: E402
from repro.training.optim import QTensor as JaxQTensor  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common import (  # noqa: E402
    ParamDecl, cast_tree, param_specs, shard_tree, tree_bytes)
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.distributed.sharding import rules_for  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.zoo import cache_specs, input_logical  # noqa: E402
from repro_torch.models.zoo import input_shapes  # noqa: E402
from repro_torch.training import QTensor, Trainer  # noqa: E402

ARCHS = list_archs()
MESHES = ((2, 4), (4, 2), (1, 4))
MODES = ("train", "prefill", "decode")
SHAPES = {"train": ("t", 32, 8, "train"), "prefill": ("p", 32, 8, "prefill"),
          "decode": ("d", 64, 8, "decode")}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, prefix + (k,)).items()}
    if isinstance(tree, list):
        return {p: x for i, v in enumerate(tree)
                for p, x in _flat(v, prefix + (i,)).items()}
    return {prefix: tree}


def _configs(arch):
    return (dataclasses.replace(jax_smoke(arch), dtype=jnp.float32),
            dataclasses.replace(get_smoke_config(arch), dtype=torch.float32))


def _dtype_name(dt) -> str:
    return str(dt)[len("torch."):] if isinstance(dt, torch.dtype) \
        else str(jnp.dtype(dt))


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_config_init_matches_the_reference(arch):
    """C15: keys, shapes, init rules, dtypes and logical axes of every
    declaration, and the dtypes of every drawn leaf, equal the reference's
    in the float32 configuration."""
    jc, pc = _configs(arch)
    jm, pm = jax_build(jc), build_model(pc)
    jd, pd = _flat(jm.decls()), _flat(pm.decls())
    assert set(jd) == set(pd)
    f32 = 0
    for key, want in jd.items():
        got = pd[key]
        assert isinstance(got, ParamDecl)
        assert (got.shape, got.logical, got.init) == \
            (want.shape, want.logical, want.init), key
        assert _dtype_name(got.dtype) == _dtype_name(want.dtype), key
        f32 += got.dtype == torch.float32
    assert f32 == sum(jnp.dtype(d.dtype) == jnp.float32 for d in jd.values())
    drawn = _flat(pm.init(0, "cpu"))
    structs = _flat(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))))
    assert set(drawn) == set(structs)
    for key, leaf in drawn.items():
        assert tuple(leaf.shape) == structs[key].shape, key
        assert _dtype_name(leaf.dtype) == _dtype_name(structs[key].dtype), key


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "seamless-m4t-large-v2"])
def test_float32_config_hidden_dtype_matches_the_reference(arch):
    """``hidden`` on the float32 configuration's own (bf16) init returns
    the reference's dtype.  seamless-m4t's encoder reads float32 frame
    embeddings against bf16 weights, which JAX promotes and PyTorch's
    products refuse (ROADMAP C16): that configuration casts its init."""
    jc, pc = _configs(arch)
    jm, pm = jax_build(jc), build_model(pc)
    toks = np.random.RandomState(0).randint(1, jc.vocab_size, (2, 16)
                                            ).astype(np.int32)
    want = jax.eval_shape(lambda p: jm.hidden(p, jnp.asarray(toks)),
                          jm.init(jax.random.PRNGKey(0)))
    with torch.no_grad():
        got = pm.hidden(pm.init(0, "cpu"), torch.from_numpy(toks))
    assert tuple(got.shape) == want.shape
    assert _dtype_name(got.dtype) == _dtype_name(want.dtype) == "bfloat16"


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "hymba-1.5b"])
def test_float32_config_cast_and_conversion(arch):
    """The float32 configuration's init cast by ``cast_tree`` and the
    reference's init carried by ``convert`` are float32 in every leaf; the
    cast leaves the values."""
    jc, pc = _configs(arch)
    pm = build_model(pc)
    init = pm.init(0, "cpu")
    cast = cast_tree(init)
    for key, leaf in _flat(cast).items():
        assert leaf.dtype == torch.float32, key
        assert torch.equal(leaf, _flat(init)[key].float()), key
    jp = jax_build(jc).init(jax.random.PRNGKey(0))
    pp = convert.model_params_from_numpy(
        pc, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp),
        "cpu")
    assert all(leaf.dtype == torch.float32 for leaf in _flat(pp).values())


def _norm(tree):
    """A spec tree as nested tuples, QTensors as ("Q", q, scale), a
    one-axis tuple entry as its axis name (JAX's normal form)."""
    if isinstance(tree, (PartitionSpec, tuple)):
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in tree)
    if isinstance(tree, (QTensor, JaxQTensor)):
        return ("Q", _norm(tree.q), _norm(tree.scale))
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_norm(v) for v in tree]
    return tree


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch, mode):
    """param_specs, state_specs (fp32 and int8 moments), input_logical
    and cache_specs under rules_for on three meshes."""
    from repro.common import param_specs as jax_param_specs
    jc, pc = jax_smoke(arch), get_smoke_config(arch)
    jm, pm = jax_build(jc), build_model(pc)
    for shape in MESHES:
        axes = ("data", "model")
        jr = jax_rules(jc, AbstractMesh(shape, axes), mode)
        pr = rules_for(pc, Mesh(shape, axes), mode)
        assert _norm(param_specs(pm.decls(), pr)) == \
            _norm(jax_param_specs(jm.decls(), jr))
        for moments in ("fp32", "int8"):
            jt = JaxTrainer(jm, JaxTrainConfig(moment_dtype=moments))
            pt = Trainer(pm, TrainConfig(moment_dtype=moments))
            assert _norm(pt.state_specs(pr)) == _norm(jt.state_specs(jr))
        cell = SHAPES[mode]
        got = input_logical(pc, ShapeConfig(*cell), pr)
        assert _norm(got) == _norm(jax_input_logical(jc, JaxShape(*cell), jr))
        if mode == "decode":
            cache = input_shapes(pc, ShapeConfig(*cell))["cache"]
            assert got["cache"] == cache_specs(cache, pr)


@pytest.mark.parametrize("arch", ["internlm2-20b", "hymba-1.5b",
                                  "dbrx-132b"])
def test_abstract_state_and_bytes_match_the_reference(arch):
    """``abstract_state``'s meta tensors against the reference's
    ``abstract_state`` (int8 moments: values and scales), and
    ``tree_bytes`` against the reference's on the parameters and the
    moments."""
    from repro.common.params import tree_bytes as jax_tree_bytes
    jc, pc = jax_smoke(arch), get_smoke_config(arch)
    tc = dict(moment_dtype="int8")
    jst = JaxTrainer(jax_build(jc), JaxTrainConfig(**tc)).abstract_state()
    pst = Trainer(build_model(pc), TrainConfig(**tc)).abstract_state()
    got, want = _flat(pst["params"]), _flat(jst["params"])
    assert set(got) == set(want)
    for key, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == want[key].shape
        assert _dtype_name(leaf.dtype) == _dtype_name(want[key].dtype)
    for key, q in _flat(pst["opt"]["m"]).items():
        jq = _flat(jst["opt"]["m"])[key]
        assert tuple(q.q.shape) == jq.q.shape and q.q.dtype == torch.int8
        assert tuple(q.scale.shape) == jq.scale.shape
    assert tree_bytes(pst["params"]) == jax_tree_bytes(jst["params"])
    # the port's step count is a Python int, the reference's an int32
    moments = ("m", "v")
    assert tree_bytes({k: pst["opt"][k] for k in moments}) == \
        jax_tree_bytes({k: jst["opt"][k] for k in moments})


@pytest.mark.parametrize("shape", MESHES)
def test_shard_tree_blocks_tile_the_whole(shape):
    """Every rank's blocks of the training state (fp32 moments) under
    state_specs, placed at their coordinates, give the whole state back."""
    cfg = get_smoke_config("internlm2-20b")
    tr = Trainer(build_model(cfg), TrainConfig(moment_dtype="fp32"))
    state = tr.init_state(0, "cpu")
    rules = rules_for(cfg, Mesh(shape, ("data", "model")), "train")
    specs = tr.state_specs(rules)
    whole = _flat(state["params"])
    spec = _flat(specs["params"])
    rebuilt = {k: torch.full_like(v, float("nan")) for k, v in whole.items()}
    for r in range(shape[0] * shape[1]):
        mesh = Mesh(shape, ("data", "model"), rank=r)
        local = _flat(shard_tree(state, specs, mesh)["params"])
        for key, block in local.items():
            idx = []
            for dim, entry in enumerate(spec[key]):
                if entry is None:
                    idx.append(slice(None))
                    continue
                n = mesh.axis_size(entry)
                i = mesh.axis_index(entry)
                size = whole[key].shape[dim] // n
                assert block.shape[dim] == size
                idx.append(slice(i * size, (i + 1) * size))
            rebuilt[key][tuple(idx)] = block
    for key, leaf in whole.items():
        assert torch.equal(rebuilt[key], leaf), key
