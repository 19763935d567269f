"""Declarative parameter trees for the port's predictor and models.

A model declares its parameters as a nested dict/list of :class:`ParamDecl`
leaves; :func:`init_params` turns it into the same nesting of tensors.  The
init draws from an explicit ``torch.Generator`` on the generator's own
device and then moves to the target device: the predictor draws on a CPU
generator, so one seed gives it the same weights on every device; a model
draws on a generator of its target device, so billions of normals never pass
through host memory.  It does not reproduce ``jax.random``: weights that
must match the JAX package are carried across with
:mod:`repro_torch.convert`.

As in the reference, a declaration carries its logical axes (one name per
dim, read through a ``ShardingRules`` table by :func:`param_specs`) and its
dtype, bf16 unless declared otherwise: a model in a float32 configuration
initialises bf16 weights, as the reference's does, and a caller that wants
float32 weights casts them (:func:`cast_tree`).  From the same declaration
come the meta-device structs of an abstract state (:func:`param_structs`)
and, over a ``launch.mesh.Mesh``, each rank's local block of a tree
(:func:`shard_tree`) and the whole tree back (:func:`gather_tree`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one."""
    return torch.device("cuda" if device is None else device)


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """Declaration of a single parameter tensor."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _init_leaf(decl: ParamDecl, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=decl.dtype, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=decl.dtype, device=device)
    # float32 draw on the generator's device, scaled in place
    draw = torch.randn(decl.shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
    if decl.init == "scaled":
        # variance-scaled (fan-in) init, the JAX package's rule verbatim
        fan_in = decl.shape[-2] if len(decl.shape) >= 2 else decl.shape[-1]
        draw.div_(np.sqrt(max(fan_in, 1)))
    else:
        draw.mul_(decl.scale)
    return draw.to(device=device, dtype=decl.dtype)


def map_tree(fn, *trees):
    """``fn`` over the leaves of parallel trees: dicts and lists nest,
    anything else (a declaration, a tensor, a spec tuple) is a leaf; the
    first tree's nesting decides."""
    node = trees[0]
    if isinstance(node, dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in node}
    if isinstance(node, list):
        return [map_tree(fn, *(t[i] for t in trees))
                for i in range(len(node))]
    return fn(*trees)


def spec_leaves(specs) -> list:
    """A spec tree's specs (tuples) in ``tree_leaves`` order: dict keys
    sorted, lists in order."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def init_params(decls, gen: torch.Generator, device=None):
    """Initialize a nested dict/list of ParamDecl (dict keys in sorted
    order, as JAX flattens them) into tensors on ``device``."""
    device = default_device(device)

    def walk(node):
        if isinstance(node, ParamDecl):
            return _init_leaf(node, gen, device)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return [walk(v) for v in node]

    return walk(decls)


def param_specs(decls, rules):
    """The mesh axes of every dim of every leaf (``rules.spec`` of its
    logical axes: the reference's PartitionSpec tree, as tuples)."""
    return map_tree(lambda d: rules.spec(d.logical), decls)


def param_structs(decls):
    """The declaration tree as tensors on the ``meta`` device: shapes and
    dtypes, no storage (the reference's ShapeDtypeStructs)."""
    return map_tree(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), decls)


def _tensors(tree):
    """The tensor leaves of a state tree: dicts, lists, and objects with
    ``q`` and ``scale`` (an int8 moment) hold them; other leaves (a step
    count) hold none."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return [tree.q, tree.scale]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a tree (meta tensors count too)."""
    return int(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def cast_tree(tree, src: torch.dtype = torch.bfloat16,
              dst: torch.dtype = torch.float32):
    """The tree with every ``src`` tensor leaf cast to ``dst`` (int8
    moments, integer leaves and other dtypes as they are): the reference
    tests' cast of a float32 configuration's bf16 init to float32."""
    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [cast(v) for v in node]
        if isinstance(node, torch.Tensor) and node.dtype == src:
            return node.to(dst)
        return node
    return cast(tree)


# --- trees over a mesh of ranks --------------------------------------------

def dim_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry shards a dim over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, a contiguous copy: each
    dim split into equal blocks over the product of its mesh axes, the
    rank's block the row-major index of its coordinates along them
    (``mesh.axis_index``)."""
    out = t
    for dim, entry in enumerate(spec):
        axes = dim_axes(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {n} blocks over {axes}")
        size = t.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(axes) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def _walk_state(fn, tree, specs):
    """``fn(tensor, spec)`` over a state tree and its spec tree (int8
    moments: ``q`` and ``scale`` with theirs); non-tensor leaves pass."""
    if isinstance(tree, dict):
        return {k: _walk_state(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(specs):
        return [_walk_state(fn, v, s) for v, s in zip(tree, specs)]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return type(tree)(q=fn(tree.q, specs.q),
                          scale=fn(tree.scale, specs.scale))
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    return tree


def shard_tree(tree, specs, mesh):
    """Each tensor leaf's local block on this rank under its spec (a tree
    of tensors, int8 moments and scalars, and its spec tree: ``param_specs``,
    ``Trainer.state_specs``, ``zoo.input_logical``)."""
    return _walk_state(lambda t, s: local_block(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """The inverse of :func:`shard_tree`: every leaf whole on every rank,
    its blocks all-gathered along each sharded dim (collective: every rank
    of the mesh calls it, counted by ``launch.mesh``)."""
    from repro_torch.launch.mesh import gather_dim

    def whole(t, spec):
        for dim in reversed(range(len(spec))):
            axes = dim_axes(spec[dim])
            if axes and mesh.axis_size(axes) > 1:
                t = gather_dim(t, dim, mesh.group(axes))
        return t

    return _walk_state(whole, tree, specs)
