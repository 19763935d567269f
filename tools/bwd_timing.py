#!/usr/bin/env python3
"""Time the flash backward kernel (``csrc/flash_attention_bwd.cu``) of a
checkout on one NVIDIA GPU, at ``chip_smoke.py`` L1's main shape and at
dbrx-132b's heads.

    python3 tools/bwd_timing.py [--root CHECKOUT] [--reps N]

``--root`` names the checkout whose ``src/repro_torch`` is built and timed
(default: the one holding this script); the harness (this script and the
cases, seeds and timer it takes from ``chip_smoke.py`` beside it) is the
same for every checkout, so one call on one card can time two commits in
turns (parent, change, change, parent).  For each of L1's ``BWD_TIMED``
cases (bf16, causal) it runs the checkout's forward kernel with its
log-sum-exp, then times the checkout's ``flash_attention_bwd_cuda`` (median
of ``--reps`` CUDA-event timings after a warm-up) and the backward of one
``scaled_dot_product_attention`` call on the same inputs, and computes the
bound from ``repro_torch.analysis`` (five products of 2 D operations per
visible pair at 989 TFLOP/s bf16).  It checks the result against the
checkout's plain ``flash_attention_bwd_ref`` within L1's limits and that
two launches are bit-identical.  It prints a line a case and one JSON
line with every number and the card's name and power limit; it exits
non-zero if a check fails or no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import (BWD_CASES, BWD_LIMITS, BWD_TIMED,  # noqa: E402
                        BWD_ULP_SHARE, gpu_line, sdpa_bwd_ms, time_ms)


def one_case(torch, i, reps):
    import torch.nn.functional as F
    from repro_torch.analysis import kernel_work, roofline
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    tag, b, s, skv, kh, g, d, window, q_off, causal, dt = BWD_CASES[i]
    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    gen = torch.Generator(device=dev).manual_seed(60 + i)
    q, do = (torch.randn(b, s, kh * g, d, generator=gen, device=dev)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, skv, kh, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_off)
    out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    again = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, do, lse, **kw)
    rel, share = 0.0, 0.0
    for x, w in zip(got, want):
        x, w = x.float(), w.float()
        rel = max(rel, float((x - w).abs().max())
                  / max(float(w.abs().max()), 1e-30))
        share = max(share, float((~torch.isclose(
            x, w, atol=1e-6, rtol=2 ** -7)).float().mean()))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = same and rel <= BWD_LIMITS[dt] and share <= BWD_ULP_SHARE
    del got, again, want
    ms = time_ms(torch, lambda: flash_attention_bwd_cuda(
        q, k, v, out, do, lse, **kw), reps, warm=3)
    lib = sdpa_bwd_ms(torch, F, print, time_ms, q, k, v, do, causal)
    nbytes, nops = kernel_work.flash_backward(b, s, skv, kh * g, kh, d,
                                              window, q_off,
                                              q.element_size(), causal)
    bound = roofline.bound_ms(nops, nbytes,
                              kernel_work.peak_for(q.element_size()))
    return dict(case=tag, ms=ms, sdpa_bwd_ms=lib, bound_ms=bound,
                max_rel=rel, ulp_share=share, bit_identical=same, ok=ok)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bwd_timing: torch.cuda.is_available() is False")
    card = gpu_line()
    print(f"root {root} | {card}", flush=True)
    rows = []
    for i in BWD_TIMED:
        row = one_case(torch, i, args.reps)
        rows.append(row)
        print(f"{row['case']}: kernel {row['ms']:.4f} ms, SDPA backward "
              f"{row['sdpa_bwd_ms']} ms, bound {row['bound_ms']:.4f} ms; "
              f"max rel {row['max_rel']:.3g}, beyond one ulp "
              f"{row['ulp_share']:.2e}, bit-identical {row['bit_identical']}",
              flush=True)
    print(json.dumps(dict(root=str(root), card=card, cases=rows)))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
