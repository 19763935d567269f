#!/usr/bin/env python3
"""Time the full-width serving endpoint of ``chip_smoke.py`` S4 for a
checkout on one NVIDIA GPU.

    python3 tools/endpoint_timing.py [--root CHECKOUT] [--passes N]

``--root`` names the checkout whose ``src/repro_torch`` is built and timed
(default: the one holding this script); the harness (this script and the
constants it takes from ``chip_smoke.py`` beside it) is the same for every
checkout, so one call on one card can time two commits in turns.  The
workload is S4's: h2o-danube-3-4b at full width and depth in bf16 with
random weights from seed 0, one ``Endpoint`` (16 slots, t_max 2,048, page
16, sync_every 8), 16 requests with S4's prompts (256..1,536 tokens, drawn
from ``RandomState(0)``) x 128 new tokens.  Each pass builds a fresh
endpoint, admits every request, then runs ``step_begin`` / ``step_end``
chunks to the end, with a device sync after each, as S4 does.  It prints
each pass's median chunk ms, tokens/s, ``step_begin`` dispatch ms and
median prefill ms, then one JSON line with the medians over the passes and
the card's name and power limit.  It checks that every request got its
tokens and that the outputs of every pass are equal; it exits non-zero if
a check fails or no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import (ENDPOINT_REQS, MAX_NEW, PROMPT_HI,  # noqa: E402
                        PROMPT_LO, gpu_line)


def one_pass(torch, np, cfg, params, dev):
    from repro_torch.serving.engine import Endpoint, Request
    ep = Endpoint(cfg, max_concurrency=ENDPOINT_REQS, t_max=2048,
                  page_size=16, sync_every=8, params=params, device=dev)
    rng = np.random.RandomState(0)
    reqs = [Request(i, rng.randint(1, cfg.vocab_size,
                                   (int(rng.randint(PROMPT_LO,
                                                    PROMPT_HI + 1)),)
                                   ).astype(np.int32), max_new=MAX_NEW)
            for i in range(ENDPOINT_REQS)]
    pre_ms = []
    for r in reqs:
        t0 = time.perf_counter()
        ep.admit(r)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    chunk_ms, begin_ms, done = [], [], []
    while ep.active_count():
        t0 = time.perf_counter()
        pending = ep.step_begin()
        begin_ms.append((time.perf_counter() - t0) * 1e3)
        done += ep.step_end(pending)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    if len(done) != ENDPOINT_REQS or any(len(r.output) != MAX_NEW
                                         for r in done):
        raise SystemExit("endpoint_timing: FAILED: not every request got "
                         f"{MAX_NEW} tokens")
    chunk = float(np.median(chunk_ms[1:] or chunk_ms))
    out = dict(chunk_ms=chunk, tokens_s=ep.L * ep.sync_every / chunk * 1e3,
               begin_ms=float(np.median(begin_ms)),
               prefill_ms=float(np.median(pre_ms)))
    outputs = {r.rid: list(r.output) for r in done}
    del ep
    return out, outputs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("endpoint_timing: torch.cuda.is_available() is "
                         "False")
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    card = gpu_line()
    print(f"root {root} | {card}", flush=True)
    dev = torch.device("cuda")
    cfg = get_config("h2o-danube-3-4b")
    params = build_model(cfg).init(0, dev)
    passes, first = [], None
    for i in range(args.passes):
        res, outputs = one_pass(torch, np, cfg, params, dev)
        if first is None:
            first = outputs
        elif outputs != first:
            raise SystemExit("endpoint_timing: FAILED: the outputs differ "
                             "between passes")
        passes.append(res)
        print(f"pass {i}: decode chunk {res['chunk_ms']:.3f} ms median, "
              f"{res['tokens_s']:.1f} tokens/s, step_begin dispatch "
              f"{res['begin_ms']:.3f} ms, prefill {res['prefill_ms']:.2f} ms "
              "(median)", flush=True)
    med = {k: float(np.median([p[k] for p in passes])) for k in passes[0]}
    print(json.dumps(dict(root=str(root), card=card, passes=passes,
                          median=med)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
