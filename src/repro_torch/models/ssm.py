"""State-space / linear-recurrence cores of the recurrent families.

The port of ``repro.models.ssm``.  ``chunked_gla`` is the shared engine of
the hybrid-SSM (hymba, its SSD heads) and xLSTM (mLSTM) blocks: gated
linear attention with a scalar decay per (head, step), evaluated in
chunks,

    S_t = a_t * S_{t-1} + k_t v_t^T          o_t = q_t^T S_t

``gla_decode_step`` is its one-token update and ``slstm_scan`` the sLSTM's
sequential scan.  The JAX package computes all three in plain jnp, outside
any Pallas kernel, so plain PyTorch is their port; a Python loop over the
chunks (over the steps, for the sLSTM) takes the place of ``lax.scan``.

Numerics follow the reference: every product that JAX accumulates in
float32 (``preferred_element_type``) takes its bf16 operands widened to
float32 (exact), the state stays float32, and the chunk boundaries are the
reference's (``chunk = min(128, s)``, ``gcd(s, chunk)`` on a ragged length:
the float32 rounding follows them).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_a: torch.Tensor, *, chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k (B,S,H,Dk), v (B,S,H,Dv), log_a (B,S,H) log decay in (-inf, 0],
    initial_state (B,H,Dk,Dv).  Returns (outputs (B,S,H,Dv) in v's dtype,
    final state (B,H,Dk,Dv) float32).

    The terms of a chunk that do not depend on the state entering it (the
    cumulative decays, the intra-chunk scores and outputs, q scaled by its
    decay, the state update's operands) are computed for every chunk at
    once; the loop carries only the state: per chunk, the inter-chunk
    output (one batched product) and the state update (a scale and one
    batched product added in place), three launches, since at a prompt
    length with no common divisor with 128 but 1 it runs once a
    position."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        # the largest common divisor, as the reference does
        chunk = math.gcd(s, chunk)
    n = s // chunk
    f32 = torch.float32

    qf = q.reshape(b, n, chunk, h, dk)
    kf = k.reshape(b, n, chunk, h, dk)
    vf = v.reshape(b, n, chunk, h, dv)
    la = log_a.to(f32).reshape(b, n, chunk, h)

    cum = torch.cumsum(la, dim=2)                  # inclusive, per chunk
    total = cum[:, :, -1]                          # (B, n, H)
    # intra-chunk: scores_ij = (q_i . k_j) * exp(cum_i - cum_j), j <= i
    scores = torch.einsum("bnchk,bndhk->bnhcd", qf.to(f32), kf.to(f32))
    decay = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).permute(
        0, 1, 4, 2, 3)                             # (B, n, H, C, C)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=q.device).tril()
    # masked inside the exponent, as the reference
    decay = torch.where(mask, decay, torch.full((), -1e30, device=q.device))
    scores = scores * torch.exp(decay)
    intra = torch.einsum("bnhcd,bndhv->bnchv", scores.to(v.dtype).to(f32),
                         vf.to(f32))

    def per_chunk(t):
        """(B, n, C, H, X) -> (n, B·H, C, X), the loop's layout."""
        return t.permute(1, 0, 3, 2, 4).reshape(n, b * h, chunk,
                                                t.shape[-1])

    # inter-chunk operand: q_i * exp(cum_i), float32
    q_dec = per_chunk(qf.to(f32) * torch.exp(cum)[..., None])
    # state update operand: k_j * exp(total - cum_j), rounded to v's dtype
    kw_t = per_chunk((kf.to(f32) * torch.exp(total[:, :, None] - cum)[
        ..., None]).to(v.dtype).to(f32)).transpose(2, 3)   # (n, BH, K, C)
    v_c = per_chunk(vf.to(f32))
    growth = torch.exp(total).permute(1, 0, 2).reshape(n, b * h, 1, 1)

    state = (torch.zeros(b * h, dk, dv, dtype=f32, device=q.device)
             if initial_state is None
             else initial_state.to(f32).reshape(b * h, dk, dv).clone())
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, log_a, initial_state)
            if t is not None):
        # the training path: the same products out of place, so autograd
        # keeps every chunk's state
        parts = []
        for c in range(n):
            parts.append(torch.bmm(q_dec[c], state))
            state = torch.baddbmm(state * growth[c], kw_t[c], v_c[c])
        inter = torch.stack(parts)
    else:
        inter = torch.empty(n, b * h, chunk, dv, dtype=f32, device=q.device)
        for c in range(n):
            torch.bmm(q_dec[c], state, out=inter[c])
            state.mul_(growth[c])
            state.baddbmm_(kw_t[c], v_c[c])
    inter = inter.reshape(n, b, h, chunk, dv).permute(1, 0, 3, 2, 4)
    out = (inter + intra).reshape(b, s, h, dv)
    return out.to(v.dtype), state.reshape(b, h, dk, dv)


def gla_ref(q, k, v, log_a, initial_state=None):
    """O(S·D²) sequential oracle for :func:`chunked_gla` (tests)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    f32 = torch.float32
    st = (torch.zeros(b, h, dk, dv, dtype=f32, device=q.device)
          if initial_state is None else initial_state.to(f32))
    outs = []
    for t in range(s):
        a = torch.exp(log_a[:, t].to(f32))[..., None, None]
        st = st * a + torch.einsum("bhk,bhv->bhkv", k[:, t].to(f32),
                                   v[:, t].to(f32))
        outs.append(torch.einsum("bhk,bhkv->bhv", q[:, t].to(f32), st))
    return torch.stack(outs, dim=1).to(v.dtype), st


def gla_decode_step(q, k, v, log_a, state):
    """Single-token recurrent update. q/k/v: (B,H,D·); log_a: (B,H);
    state (B,H,Dk,Dv) float32.  Returns (out (B,H,Dv) in v's dtype, the new
    state)."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None, None]
    state = state * a + torch.einsum("bhk,bhv->bhkv", k.to(f32), v.to(f32))
    out = torch.einsum("bhk,bhkv->bhv", q.to(f32), state)
    return out.to(v.dtype), state


def slstm_scan(x_gates: torch.Tensor, r_w: torch.Tensor,
               state: Optional[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]] = None):
    """sLSTM: the sequential scalar-memory recurrence with a normalizer.

    x_gates (B,S,4,H,Dh) pre-activations of z, i, f, o; r_w (4,H,Dh,Dh)
    the recurrent head-block-diagonal weights.  Returns (h_seq (B,S,H,Dh)
    float32, (c, n, h) final).  The recurrent weights sit inside the gate
    nonlinearity, so the scan is not associative: one step at a time."""
    b, s, _, h, dh = x_gates.shape
    f32 = torch.float32
    if state is None:
        zeros = torch.zeros(b, h, dh, dtype=f32, device=x_gates.device)
        state = (zeros, zeros + 1e-6, zeros)
    c, n, h_prev = state
    xg = x_gates.to(f32)
    # the recurrent product of all four gates as one batched product per
    # head: (H, Dh, 4·Dh)
    rw = r_w.to(f32).permute(1, 2, 0, 3).reshape(h, dh, 4 * dh)
    floor = torch.full((), 1e-6, device=x_gates.device)
    hs = []
    for t in range(s):
        rec = torch.bmm(h_prev.transpose(0, 1), rw)   # (H, B, 4·Dh)
        pre = xg[:, t] + rec.reshape(h, b, 4, dh).permute(1, 2, 0, 3)
        z = torch.tanh(pre[:, 0])
        gate = torch.sigmoid(pre[:, 1:])             # i, f, o
        i, f, o = gate[:, 0], gate[:, 1], gate[:, 2]
        c = f * c + i * z
        n = f * n + i
        h_prev = o * c / torch.maximum(n, floor)
        hs.append(h_prev)
    return torch.stack(hs, dim=1), (c, n, h_prev)

