"""Per-(architecture, execution-mode) sharding rule resolution.

The port of ``repro.distributed.sharding``, over the port's ``Mesh`` (a
mesh built from a shape alone will do: only its axis names and sizes are
read).  Policy:

* train  — FSDP('data') x TP('model'); batch over ('pod','data').
* prefill— serving weights (TP only, no FSDP); attention per arch policy.
* decode — serving weights; KV cache sequence-sharded over 'model'
           (flash-decode), attention heads replicated at compute time.

Archs whose head counts don't divide the TP degree fall back to
sequence-parallel attention.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.common.sharding import ShardingRules, base_rules
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh


def rules_for(cfg: ModelConfig, mesh: Mesh, mode: str,
              global_batch: Optional[int] = None) -> ShardingRules:
    assert mode in ("train", "prefill", "decode"), mode
    multi_pod = "pod" in mesh.axis_names
    tp = mesh.shape["model"]

    policy = cfg.attn_policy
    if policy == "head_tp" and cfg.n_heads % tp != 0:
        policy = "seq_sp"

    rules = base_rules(multi_pod, fsdp=(mode == "train"), attn_policy=policy)

    overrides = {}
    if policy == "head_tp" and cfg.n_kv_heads % tp != 0:
        # Megatron GQA practice: replicate KV heads when kv < tp
        overrides["kv_heads"] = None
        overrides["p_kv_heads"] = None
    if mode == "decode":
        # flash-decode: heads replicated at compute, KV sequence over 'model'
        # (recurrent states are batch-sharded only: nothing more to set)
        overrides.update({
            "heads": None, "kv_heads": None, "qseq": None,
            "cache_seq": "model",
        })
    if mode in ("prefill", "decode"):
        # serving weights: no FSDP gather per token
        overrides["p_embed"] = None
    if global_batch is not None and global_batch % dp_degree(mesh) != 0:
        # batch too small for DP: replicate the batch, and spread the KV
        # sequence over both axes (SP-decode)
        overrides.update({"batch": None, "cache_batch": None})
        if mode == "decode":
            axes = ("pod", "data", "model") if multi_pod else ("data", "model")
            overrides["cache_seq"] = axes
    return rules.with_overrides(**overrides)


def dp_axes(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_degree(mesh: Mesh) -> int:
    d = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        d *= mesh.shape["pod"]
    return d
