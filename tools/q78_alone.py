#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s C16 endpoint check and phase Q's Q7 (the
elastic re-mesh) and Q8 (dbrx-132b's sharded train step) alone on one
NVIDIA GPU, with the script's own checks.

    python3 tools/q78_alone.py [--parts c16,q7,q8]

Builds the kernels, then runs the parts named: C16's uncast float32
endpoint (``uncast_endpoint_check``); Q8's one-rank step in a process of
its own (``q8_one``); then one group of four ranks sharing the card over
gloo that runs ``q7_rank`` and/or ``q8_rank``, and holds them with
``q7_report`` and ``q8_report``.  It prints the card's name and power
limit, each part's line and a JSON line of the reports, then the count of
failed checks; it exits non-zero if a check fails or no CUDA device is
present.  The times are four processes time-sliced on one card over
host-staged gloo, not a multi-card time.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))
import chip_smoke as cs  # noqa: E402

PARTS = ("c16", "q7", "q8")


def group_rank(rank, world, device, args):
    """One rank of the group: Q7 and/or Q8 as ``args["parts"]`` names."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    t0 = time.perf_counter()
    if "q7" in args["parts"]:
        out["q7"] = cs.q7_rank(torch, np, device, rank, world, args["q7_dir"])
    if "q8" in args["parts"]:
        out["q8"] = cs.q8_rank(torch, np, device, rank, world,
                               args["q8_path"])
    out["s"] = time.perf_counter() - t0
    return out


def one_rank(rank, world, device, args):
    return cs.q8_one(rank, world, device, args)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    parts = tuple(p for p in ap.parse_args().parts.split(",") if p)
    if any(p not in PARTS for p in parts):
        ap.error(f"--parts takes some of {PARTS}")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    fails = []

    def check(ok, msg):
        if not ok:
            fails.append(msg)
            print("FAIL:", msg, flush=True)

    def say(*a):
        print(*a, flush=True)

    say(cs.gpu_line())
    t0 = time.perf_counter()
    _build.build_all()
    say(f"kernels built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    if "c16" in parts:
        cs.uncast_endpoint_check(torch, np, dev, say, check)
    work = Path(tempfile.mkdtemp(prefix="q78-"))
    me = f"{Path(__file__).resolve()}"
    reports = {}
    try:
        one = None
        if "q8" in parts:
            t0 = time.perf_counter()
            one = run_ranks(f"{me}:one_rank", 1, backend="gloo",
                            device="cuda", timeout=cs.Q_TIMEOUT,
                            args=dict(path=str(work / "q8_moments")))[0]
            say(f"Q8 one-rank process: {time.perf_counter() - t0:.1f} s")
        if "q7" in parts or "q8" in parts:
            t0 = time.perf_counter()
            ranks = run_ranks(f"{me}:group_rank", cs.Q_RANKS, backend="gloo",
                              device="cuda", timeout=cs.Q_TIMEOUT,
                              args=dict(parts=parts, q7_dir=str(work / "q7"),
                                        q8_path=str(work / "q8_moments")))
            say(f"group: {time.perf_counter() - t0:.1f} s, rank 0's parts "
                f"{ranks[0]['s']:.1f} s")
            if "q7" in parts:
                reports["Q7"] = cs.q7_report(torch, dev, say, check, ranks)
            if "q8" in parts:
                reports["Q8"] = cs.q8_report(torch, dev, say, check, ranks,
                                             one)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(json.dumps(reports, default=str))
    say(f"failed checks: {len(fails)}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
