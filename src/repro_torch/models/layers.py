"""Shared neural-net building blocks (functions over ParamDecl trees).

The port of ``repro.models.layers``: RMSNorm (float32 inside), RoPE, the
gated MLP, the embedding lookup, the LM head, the chunked-vocabulary
cross-entropy of the training loss and the depthwise causal convolution of
the recurrent blocks.  Every declaration carries the reference's logical
axes and its dtype (bf16, whatever the config's dtype).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common import ParamDecl


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * w


def norm_decl(d: int) -> ParamDecl:
    return ParamDecl((d,), ("p_none",), init="ones")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S) or (S,).
    Angles, sines and the rotation in float32; the result in x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs          # (..., S, half)
    sin = torch.sin(angles)[..., None, :]                  # over the heads
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_decls(d: int, ff: int) -> dict:
    return {
        "w_gate": ParamDecl((d, ff), ("p_embed", "p_mlp"), init="scaled"),
        "w_up": ParamDecl((d, ff), ("p_embed", "p_mlp"), init="scaled"),
        "w_down": ParamDecl((ff, d), ("p_mlp", "p_embed"), init="scaled"),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_decls(padded_vocab: int, d: int) -> ParamDecl:
    return ParamDecl((padded_vocab, d), ("p_vocab", "p_embed"), init="normal")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def logits_for(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """h: (..., d) -> logits (..., V_padded), in the model dtype."""
    return h @ table.t()


def chunked_softmax_xent(table: torch.Tensor, hidden: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         vocab_size: int, chunk: int) -> torch.Tensor:
    """The mean masked NLL: :func:`xent_sums`'s NLL sum over max(mask sum,
    1)."""
    tot, cnt = xent_sums(table, hidden, labels, mask, vocab_size, chunk)
    return tot / torch.clamp(cnt, min=1.0)


def xent_sums(table: torch.Tensor, hidden: torch.Tensor,
              labels: torch.Tensor, mask: torch.Tensor, vocab_size: int,
              chunk: int):
    """Cross-entropy without materializing the (tokens, V) logits at once.

    hidden (B, S, d); labels/mask (B, S); table (V_padded, d).  A loop over
    token chunks of ``chunk``: each computes its float32 logits (one
    product of the chunk's hidden rows and the table, both widened to
    float32: exact products, float32 sums, as the reference's
    ``preferred_element_type``), masks the vocabulary padding with -1e30,
    and adds its masked NLL (logsumexp minus the gold score) and mask
    count.  Returns (the NLL sum, the mask sum), float32 0-d.  No chunk is
    rematerialized: under autograd each keeps its logits for the backward,
    as the reference's ``lax.scan`` keeps its residuals."""
    b, s, d = hidden.shape
    t = b * s
    h = hidden.reshape(t, d)
    y = labels.reshape(t).long()
    m = mask.reshape(t).to(torch.float32)

    chunk = min(chunk, t)
    n = t // chunk
    rem = t - n * chunk
    assert rem == 0, f"token count {t} not divisible by logit_chunk {chunk}"

    tab = table.float()
    pad = (torch.arange(table.shape[0], device=table.device) >= vocab_size
           if table.shape[0] > vocab_size else None)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = h[sl].float() @ tab.t()              # (chunk, V_padded)
        if pad is not None:
            logits = logits.masked_fill(pad[None, :], -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(1, y[sl, None])[:, 0]
        tot = tot + ((lse - gold) * m[sl]).sum()
        cnt = cnt + m[sl].sum()
    return tot, cnt


# ---------------------------------------------------------------------------
# Depthwise causal conv (the recurrent blocks' short convolution)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """x (B, S, C); w (K, C) depthwise kernel; state the trailing (B, K-1,
    C) window of the previous call (None: zeros).  Returns (y, new state),
    pad + K shifted adds in x's dtype, as the reference (K is tiny)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + xp[:, i:i + x.shape[1], :] * w[i]
    new_state = (xp[:, -(k - 1):, :] if k > 1
                 else x.new_zeros((x.shape[0], 0, x.shape[2])))
    return y, new_state
