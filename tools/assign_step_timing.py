#!/usr/bin/env python3
"""Time the assign-step kernel and the seed's per-iteration solve of a
checkout on one NVIDIA GPU, and hold them to the plain version.

    python3 tools/assign_step_timing.py [--root CHECKOUT]

``--root`` names the checkout whose ``src/repro_torch`` is built and timed
(default: the one holding this script); the harness (``chip_smoke.py``
beside this script) is the same for every checkout, so one call on one card
can time two commits in turns.  Inputs are ``chip_smoke.py`` 3e's: uniform
cost and quality (N 16,384, M 6) from a seeded generator, α 0.7, loads
N/2, 150 iterations.  It checks the step against ``assign_step_ref`` at the
seed solve's final multipliers and at zero, and the seed solve eager,
captured once into a CUDA graph and replayed, and on the CPU, all bit for
bit.  Then it prints the step's time with its wrapper, the wrapper's host
µs, the device time (a CUDA graph of 50 calls), one launch's floor, the
device kernels one step enqueues, and the seed solve's ms eager, captured
and against the fused one-launch solve, then one JSON line.  It exits
non-zero if a check fails or no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import (SEED_ITERS, captured_call, gpu_line,  # noqa: E402
                        same_solve, seed_inputs, seed_loop, seed_timing,
                        step_bytes_ops, step_timing, H100_HBM)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("assign_step_timing: torch.cuda.is_available() is "
                         "False")
    from repro_torch.kernels.lagrangian_assign import ops
    from repro_torch.kernels.lagrangian_assign.kernel import assign_step_cuda
    from repro_torch.kernels.lagrangian_assign.ref import assign_step_ref

    card = gpu_line()
    print(f"root {root} | {card}", flush=True)
    dev = torch.device("cuda")
    sargs = seed_inputs(torch, dev)
    c, a, alpha, loads, iters = sargs

    def fail(what):
        raise SystemExit(f"assign_step_timing: FAILED: {what}")

    ops.step_launches = 0
    eager = seed_loop(torch, ops.assign_step, *sargs)
    if ops.step_launches != iters + 1:
        fail(f"{ops.step_launches} launches in a seed solve")
    cpu = seed_loop(torch, ops.assign_step, c.cpu(), a.cpu(), alpha,
                    loads.cpu(), iters)
    graph, captured = captured_call(
        torch, lambda: seed_loop(torch, ops.assign_step, *sargs))
    for t in captured:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    if not (same_solve(eager, cpu) and same_solve(captured, eager)):
        fail("the seed solve differs between eager, captured and the CPU")
    lam1, lam2 = eager[1], eager[2]
    for l1, l2 in ((lam1, lam2), (lam1 * 0, lam2 * 0)):
        got = assign_step_cuda(c, a, l1, l2)
        want = assign_step_ref(c, a, l1, l2, c.shape[0])
        if not all(bool(torch.equal(g, w)) for g, w in zip(got, want)):
            fail("the step differs from assign_step_ref")
    print("checks: step = plain bit for bit; seed solve eager = captured = "
          "CPU bit for bit", flush=True)

    tm = step_timing(torch, assign_step_cuda, c, a, lam1, lam2)
    tm.update(seed_timing(torch, ops.assign_step, sargs, graph,
                          lambda: ops.solve_assignment_kernel(c, a, alpha,
                                                              loads)))
    n, m = c.shape
    tm["bound_ms"] = step_bytes_ops(n, m)[0] / H100_HBM * 1e3
    print(f"N={n} M={m}: with the wrapper {tm['ms'] * 1e3:.3f} us, host "
          f"{tm['host_us']:.3f} us, device {tm['graph_ms'] * 1e3:.3f} us, "
          f"launch floor {tm['floor_ms'] * 1e3:.3f} us, bound "
          f"{tm['bound_ms'] * 1e3:.4f} us; device kernels a step "
          f"{tm['device_kernels']}; seed solve eager "
          f"{tm['seed_loop_ms']:.3f} ms, captured {tm['seed_graph_ms']:.3f} "
          f"ms, fused {tm['fused_solve_ms']:.3f} ms ({SEED_ITERS} "
          f"iterations)", flush=True)
    print(json.dumps({"root": str(root), "card": card, **tm}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
