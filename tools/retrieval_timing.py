#!/usr/bin/env python3
"""Time the retrieval kernel (vote and top-k entry points) of a checkout on
one NVIDIA GPU, at the routing plane's shapes, and hold it to its plain
version.

    python3 tools/retrieval_timing.py [--root CHECKOUT] [--reps N]

``--root`` names the checkout whose ``src/repro_torch`` is built and timed
(default: the one holding this script), so one call on one card can time
two commits in turns.  Inputs are made from a seed: a 131,072 x 256 store
of unit rows, 12 label columns, and unit queries at the route batch
(16,384) and the stream window (4,096); k = 8.  For each batch it prints
the kernel's median CUDA-event time for both entry points, ``torch.matmul``
of the same float32 product, ``torch.matmul`` + ``torch.topk``, and the two
bounds (float32 on the CUDA cores, 3xTF32 on the tensor cores), then one
JSON line.  Before timing it checks each entry point against the plain
version on the first 1,024 queries (vals within 1e-5, sorted index rows
equal on at least 0.999) and that the two entry points agree bit for bit;
it exits non-zero if a check fails or no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import gpu_line, retrieval_bounds, time_ms  # noqa: E402

N_DB, D, N_LAB, K = 131_072, 256, 12, 8
BATCHES = (16_384, 4_096)
CMP = 1_024


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("retrieval_timing: torch.cuda.is_available() is False")
    from repro_torch.kernels.topk_retrieval.kernel import (
        retrieval_vote_cuda, topk_retrieval_cuda)
    from repro_torch.kernels.topk_retrieval.ref import retrieval_vote_ref
    torch.backends.cuda.matmul.allow_tf32 = False

    card = gpu_line()
    print(f"root {root} | {card}", flush=True)
    gen = torch.Generator().manual_seed(0)

    def unit(n):
        x = torch.randn(n, D, generator=gen)
        return (x / x.norm(dim=1, keepdim=True)).cuda().contiguous()

    store = unit(N_DB)
    labels = torch.rand(N_DB, N_LAB, generator=gen).cuda()
    out = {"root": str(root), "card": card, "batches": []}
    for b in BATCHES:
        q = unit(b)
        vv, vi, vvote = retrieval_vote_cuda(store, labels, q, K)
        tv, ti = topk_retrieval_cuda(store, q, K)
        torch.cuda.synchronize()
        rv, ri, rvote = retrieval_vote_ref(store, labels, q[:CMP], K)
        err = (vv[:CMP] - rv).abs().max().item()
        agree = (torch.sort(vi[:CMP], 1).values
                 == torch.sort(ri, 1).values).float().mean().item()
        dvote = (vvote[:CMP] - rvote).abs().max().item()
        same = bool(torch.equal(vv, tv) and torch.equal(vi, ti))
        print(f"B={b}: max|dvals|={err:.3g} idx agree={agree:.6f} "
              f"max|dvote|={dvote:.3g} entry points equal {same}",
              flush=True)
        if not (err <= 1e-5 and agree >= 0.999 and same):
            raise SystemExit(f"retrieval_timing: FAILED at B={b}")
        vote_ms = time_ms(torch, lambda: retrieval_vote_cuda(
            store, labels, q, K), args.reps)
        topk_ms = time_ms(torch, lambda: topk_retrieval_cuda(store, q, K),
                          args.reps)
        st = store.T
        mm_ms = time_ms(torch, lambda: torch.matmul(q, st), args.reps)
        two_ms = time_ms(torch, lambda: torch.topk(torch.matmul(q, st), K,
                                                   dim=1), args.reps)
        _, _, fp32_b, tf32_b = retrieval_bounds(b, N_DB, D, K, N_LAB)
        row = dict(b=b, vote_ms=vote_ms, topk_ms=topk_ms, matmul_ms=mm_ms,
                   matmul_topk_ms=two_ms, bound_fp32_ms=fp32_b,
                   bound_3xtf32_ms=tf32_b, max_abs_err=err, idx_agree=agree)
        out["batches"].append(row)
        print(f"B={b} N_db={N_DB} d={D} k={K}: vote {vote_ms:.3f} ms, top-k "
              f"{topk_ms:.3f} ms, torch.matmul {mm_ms:.3f} ms, matmul + topk "
              f"{two_ms:.3f} ms; bound fp32 {fp32_b:.3f} ms, 3xTF32 "
              f"{tf32_b:.3f} ms", flush=True)
        del q, vv, vi, vvote, tv, ti
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
