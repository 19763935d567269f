"""Entry points of the paged decode, paged verify and dense-cache decode
and verify attention, dispatched by device.

A CUDA tensor launches the hand-written kernel (``kernel.py``) or raises;
a CPU tensor runs the plain PyTorch version (``ref.py``).  ``launches``
counts the decode kernel calls made through ``paged_decode_attention``,
``verify_launches`` the verify kernel calls made through
``paged_verify_attention`` and ``dense_launches`` the dense-cache kernel
calls made through ``decode_attention`` and ``verify_attention`` (one per
call: the split pass and its merge) and ``partial_launches`` the dense
kernel's split pass alone, made through ``decode_attention_partials``.

``merge_partials`` is the reference's log-sum-exp merge of split partials
(jnp outside the Pallas kernel there, plain PyTorch here), and
``sharded_decode_attention`` the sequence-sharded decode: each rank holds
a slice of the cache's positions, computes its slice's partials and
merges every rank's, gathered in rank order.

Queries of another dtype than the pools or caches (bf16 queries against a
float32 configuration's float32 pools) are promoted as JAX promotes them
before they reach a kernel, whose operands share one dtype
(``kernels.promoted``); the result takes q's dtype.
"""
from __future__ import annotations

import torch

from .. import promoted
from .kernel import (decode_attention_cuda, decode_attention_partials_cuda,
                     paged_decode_attention_cuda,
                     paged_verify_attention_cuda)
from .ref import (decode_attention_partials_ref, decode_attention_ref,
                  paged_decode_attention_ref, paged_verify_attention_ref,
                  verify_attention_ref)

launches = 0
verify_launches = 0
dense_launches = 0
partial_launches = 0



@promoted
def paged_decode_attention(q, k_pages, v_pages, block_table, lens, *,
                           window: int = 0):
    """q (B,1,H,D); pools (n_pages, PS, K, D); block_table (B,P) int32;
    lens (B,) int32 valid lengths.  Returns (B,1,H,D) in q's dtype."""
    global launches
    if q.is_cuda:
        out = paged_decode_attention_cuda(q, k_pages, v_pages, block_table,
                                          lens, window=window)
        launches += 1
        return out
    if q.device.type != "cpu":
        raise ValueError(f"no paged decode attention for device {q.device}")
    return paged_decode_attention_ref(q, k_pages, v_pages, block_table, lens,
                                      window=window)


@promoted
def paged_verify_attention(q, k_pages, v_pages, block_table, lens, *,
                           window: int = 0):
    """q (B,S,H,D): query s of sequence b attends to positions < lens[b] +
    s; pools, block_table and lens as ``paged_decode_attention``.  Returns
    (B,S,H,D) in q's dtype."""
    global verify_launches
    if q.is_cuda:
        out = paged_verify_attention_cuda(q, k_pages, v_pages, block_table,
                                          lens, window=window)
        verify_launches += 1
        return out
    if q.device.type != "cpu":
        raise ValueError(f"no paged verify attention for device {q.device}")
    return paged_verify_attention_ref(q, k_pages, v_pages, block_table, lens,
                                      window=window)


@promoted
def decode_attention(q, k_cache, v_cache, lens, *, window: int = 0):
    """q (B,1,H,D); caches (B,T,K,D); lens the valid lengths, an int or a
    0-d tensor shared by the batch, or (B,) per sequence.  Returns
    (B,1,H,D) in q's dtype."""
    global dense_launches
    if q.is_cuda:
        out = decode_attention_cuda(q, k_cache, v_cache,
                                    _batch_lens(lens, q.shape[0], q.device),
                                    window=window)
        dense_launches += 1
        return out
    if q.device.type != "cpu":
        raise ValueError(f"no decode attention for device {q.device}")
    return decode_attention_ref(q, k_cache, v_cache,
                                torch.as_tensor(lens, dtype=torch.int32),
                                window=window)


def _batch_lens(lens, b: int, device) -> torch.Tensor:
    """Valid lengths as the kernels take them: (B,) int32 on the device.
    A host int is filled on the device (no host-to-device copy)."""
    if isinstance(lens, torch.Tensor):
        return lens.to(device, torch.int32).expand(b).contiguous()
    return torch.full((b,), int(lens), dtype=torch.int32, device=device)


@promoted
def verify_attention(q, k_cache, v_cache, lens, *, window: int = 0):
    """The dense-cache verify: q (B,S,H,D), query s of sequence b attends
    to positions < lens[b] + s of the caches (B,T,K,D); lens an int or a
    0-d tensor shared by the batch, or (B,) per sequence.  On the card the
    dense-cache kernel at S positions (one call, counted in
    ``dense_launches``); on the CPU ``ref.verify_attention_ref``.  Returns
    (B,S,H,D) in q's dtype."""
    global dense_launches
    if q.is_cuda:
        out = decode_attention_cuda(q, k_cache, v_cache,
                                    _batch_lens(lens, q.shape[0], q.device),
                                    window=window)
        dense_launches += 1
        return out
    if q.device.type != "cpu":
        raise ValueError(f"no verify attention for device {q.device}")
    return verify_attention_ref(q, k_cache, v_cache,
                                torch.as_tensor(lens, dtype=torch.int32)
                                .expand(q.shape[0]), window=window)


def decode_attention_partials(q, k_cache, v_cache, lens):
    """The dense decode's unmerged split partials (o (B,K,S,G,D), m, l
    (B,K,S,G), float32): q (B,1,H,D); caches (B,T,K,D); lens an int, a 0-d
    tensor or (B,) valid lengths (0 allowed)."""
    global partial_launches
    if q.is_cuda:
        out = decode_attention_partials_cuda(
            q, k_cache, v_cache, _batch_lens(lens, q.shape[0], q.device))
        partial_launches += 1
        return out
    if q.device.type != "cpu":
        raise ValueError(f"no decode attention partials for device "
                         f"{q.device}")
    return decode_attention_partials_ref(
        q, k_cache, v_cache, torch.as_tensor(lens, dtype=torch.int32)
        .expand(q.shape[0]))


def merge_partials(o, m, l):
    """Merge split partials over the split axis: o (B,K,S,G,D); m, l
    (B,K,S,G).  Returns (B,K,G,D) float32.  A split with no valid position
    (m = NEG_INF) is annihilated by the exp correction; a row with none at
    all gets 0."""
    m_glob = m.amax(2, keepdim=True)                        # (B,K,1,G)
    corr = torch.exp(m - m_glob)
    l_glob = (l * corr).sum(2)                              # (B,K,G)
    o_glob = (o * corr[..., None]).sum(2)                   # (B,K,G,D)
    return o_glob / torch.clamp(l_glob, min=1e-30)[..., None]


def sharded_decode_attention(q, k_cache, v_cache, pos, *, offset: int,
                             group):
    """The decode of one position over a cache whose positions are split
    over the ranks of ``group``: q (B,1,H,D), the same on every rank;
    k_cache, v_cache (B, T_loc, K, D) this rank's slice, its first position
    ``offset`` (the slices in group-rank order); pos (an int or (B,)) the
    valid length of the whole cache.  Each rank takes its slice's partials
    at lens max(pos - offset, 0), the ranks all-gather them along the split
    axis in rank order and each merges them all.  Returns (B,1,H,D) in q's
    dtype on every rank."""
    from repro_torch.launch.mesh import gather_dim
    lens = torch.clamp(torch.as_tensor(pos, dtype=torch.int32,
                                       device=q.device) - offset, min=0)
    o, m, l = decode_attention_partials(q, k_cache, v_cache, lens)
    o, m, l = (gather_dim(x, 2, group) for x in (o, m, l))
    b, _, h, d = q.shape
    return merge_partials(o, m, l).reshape(b, 1, h, d).to(q.dtype)
