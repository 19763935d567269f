"""Logical-axis sharding rules, and the mesh the routing plane runs on.

The port of ``repro.common.sharding``.  A :class:`ShardingRules` table maps
logical axis names (``"batch"``, ``"query"``, ``"p_experts"``, ...) to mesh
axes; ``use_mesh`` activates a (mesh, rules) pair for this thread, and the
code that distributes reads it back (``active_mesh``, ``query_axis_info``).
The tables are the reference's, entry for entry.

The port has no GSPMD: nothing partitions a program from annotations, so
:func:`logical_shard` returns its argument unchanged.  Its sharding is
explicit wherever the reference uses ``shard_map``: each rank holds its
own shard (the query-sharded blocked solve, ``models.moe.moe_ep``,
``distributed.compression``, ``distributed.pipeline``) and the collectives
are those of ``repro_torch.launch.mesh``.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field, replace
from typing import Mapping, Optional, Sequence, Union

from repro_torch.launch.mesh import Mesh

MeshAxes = Union[str, Sequence[str], None]


@dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to a mesh axis (or axes)."""

    rules: Mapping[str, MeshAxes] = field(default_factory=dict)

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        axes = self.rules.get(logical, None)
        if isinstance(axes, list):
            return tuple(axes)
        return axes

    def spec(self, logical_axes: Sequence[Optional[str]]) -> tuple:
        """The mesh axes of each logical axis (the reference's
        ``PartitionSpec`` entries)."""
        return tuple(self.mesh_axes(a) for a in logical_axes)

    def with_overrides(self, **overrides: MeshAxes) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return replace(self, rules=merged)


class _MeshContext(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Optional[ShardingRules] = None


_CTX = _MeshContext()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[ShardingRules]):
    """Activate (mesh, rules) in this thread."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def active_rules() -> Optional[ShardingRules]:
    return _CTX.rules


def logical_shard(x, *logical_axes: Optional[str]):
    """The identity: the port has no partitioner to annotate for (see the
    module docstring)."""
    return x


# ---------------------------------------------------------------------------
# Default logical-axis tables (the reference's).
#
# Mesh axes: single-pod ('data','model'); multi-pod ('pod','data','model').
# 'data' doubles as the FSDP axis for parameter storage during training.
# ---------------------------------------------------------------------------

def base_rules(multi_pod: bool = False, *, fsdp: bool = True,
               attn_policy: str = "head_tp") -> ShardingRules:
    """The standard rule table.

    attn_policy:
      'head_tp'  — attention heads sharded over 'model'
      'seq_sp'   — sequence-parallel attention (heads replicated, q-seq
                   sharded)
    """
    dp = ("pod", "data") if multi_pod else ("data",)
    fs = "data" if fsdp else None
    rules = {
        # activations
        "batch": dp,
        "seq": None,
        "embed": None,
        "heads": "model" if attn_policy == "head_tp" else None,
        "kv_heads": "model" if attn_policy == "head_tp" else None,
        "head_dim": None,
        "qseq": "model" if attn_policy == "seq_sp" else None,
        "kvseq": None,
        "mlp_act": "model",
        "vocab_act": "model",
        # decode-time KV cache: sequence split over 'model' (flash-decode)
        "cache_seq": "model",
        "cache_batch": dp,
        "cache_kv_heads": None,
        # parameter storage axes
        "p_embed": fs,
        "p_mlp": "model",
        "p_heads": "model",
        "p_kv_heads": "model",
        "p_vocab": "model",
        "p_experts": "data",
        "p_expert_embed": None,
        "p_layers": None,
        "p_none": None,
        # optimizer / ZeRO
        "zero": ("data",),
        # router / ECCOS
        "queries": dp,
        "models": None,
        "db_rows": "model",
        "db_dim": None,
        # the query-sharded dual solve: the routing problem's query axis
        "query": dp,
    }
    if attn_policy == "seq_sp":
        # attention projections stay FSDP-sharded on the embed dim
        rules["p_heads"] = None
        rules["p_kv_heads"] = None
    return ShardingRules(rules=rules)


# ---------------------------------------------------------------------------
# The query-sharded routing mesh.
# ---------------------------------------------------------------------------

def query_mesh(n_ranks: int = 0) -> Mesh:
    """A 1-D ``("data",)`` mesh over the ranks for query-sharded routing
    (the routing plane has no model parallelism).  ``n_ranks`` of 0 is the
    whole world; any other value must equal it, since every rank of a
    ``torch.distributed`` world runs the program."""
    import torch.distributed as dist
    world = dist.get_world_size()
    n = n_ranks or world
    if n != world:
        raise ValueError(f"query_mesh({n_ranks}) over a world of {world} "
                         "ranks: every rank joins the query mesh")
    return Mesh.build((n,), ("data",))


def query_rules(multi_pod: bool = False) -> ShardingRules:
    """The routing plane's rule table: queries sharded, everything else
    (the models axis, the VectorStore) replicated."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(rules={"query": dp, "queries": dp, "models": None,
                                "db_rows": None, "db_dim": None})


def query_axis_info():
    """(mesh, mesh axes tuple, total size) of the active ``"query"``
    logical axis, or None when no active mesh shards queries: the hook the
    dual solver reads to decide whether a solve is sharded."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return None
    axes = rules.mesh_axes("query")
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    if size <= 1:
        return None
    return mesh, tuple(axes), size
