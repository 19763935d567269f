#!/usr/bin/env python3
"""Split the assign-step kernel's device time into its phases on one NVIDIA
GPU, by timing cut-down copies of it.

    python3 tools/assign_step_ablation.py [--rounds N]

It writes variants of ``src/repro_torch/csrc/shard_stats.cu`` into
``build/repro_torch/ablation/``, each one edit of the source text, builds
them with the library's own flags (one ``nvcc`` each, all started
together), and times each ``assign_step_launch`` at N 16,384, M 6 (seeded
uniform inputs) as ``chip_smoke.graph_ms`` does: a CUDA graph of 50 calls,
replayed.  The variants, each a prefix of the kernel's work:

- ``empty``: returns at once (the grid's launch, 64 CTAs of 256 threads);
- ``loads``: the loads, the row scan with a multiply in the division's
  place, and ``x``;
- ``scan``: the same with the kernel's IEEE division;
- ``partial``: and the 256-row block partial;
- ``kernel``: the kernel as it is (the ticket and the last CTA's merge);
- ``fenced``: the kernel with its acquire-release ticket replaced by
  ``__threadfence(); atomicAdd; __threadfence()``.

``kernel`` and ``fenced`` are held to ``assign_step_ref`` bit for bit, and
``zero_()`` of one element in the same kind of graph gives one launch's
floor.  The variants are probes, not kernels of the port.  It prints each
variant's µs per round and one JSON line, and exits non-zero if a check
fails or no CUDA device is present.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))
from chip_smoke import gpu_line, graph_ms, launch_floor_ms  # noqa: E402

N, M = 16_384, 6
SCAN_END = "  ascent::block_partial<1>(vq, vc, col, m, part"
PARTIAL_END = "  // the barrier orders the partial's writes"
START = "  const bool live = r < n;\n"
TICKET = '''  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(ticket) : "memory");
  return old;'''
FENCED = '''  __threadfence();
  const unsigned old = atomicAdd(ticket, 1u);
  __threadfence();
  return old;'''


def variants(src: str):
    for anchor in (SCAN_END, PARTIAL_END, START, TICKET):
        if src.count(anchor) != 1:
            raise SystemExit(f"assign_step_ablation: the source no longer "
                             f"holds {anchor.strip()!r} once")
    scan = src.replace(SCAN_END, "  return;\n" + SCAN_END)
    return {
        "empty": src.replace(START, START + "  return;\n"),
        "loads": scan.replace("__fdiv_rn(", "__fmul_rn("),
        "scan": scan,
        "partial": src.replace(PARTIAL_END, "  return;\n" + PARTIAL_END),
        "kernel": src,
        "fenced": src.replace(TICKET, FENCED),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("assign_step_ablation: torch.cuda.is_available() "
                         "is False")
    from repro_torch.kernels import _build
    from repro_torch.kernels.lagrangian_assign.ref import assign_step_ref

    out_dir = _build.BUILD / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "shard_stats.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS["shard_stats"], "-I",
             str(_build.CSRC), "-o", str(out_dir / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"assign_step_ablation: nvcc failed for "
                             f"{name}:\n{log}")

    card = gpu_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    c = torch.rand(N, M, generator=gen, device=dev)
    a = torch.rand(N, M, generator=gen, device=dev)
    lam1 = torch.tensor(300.0, device=dev)
    lam2 = torch.rand(M, generator=gen, device=dev) * 0.01
    bps = -(-N // 256)
    x = torch.empty(N, dtype=torch.int32, device=dev)
    out = torch.empty(2 + M, device=dev)
    part = torch.empty(bps * (2 + M), device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    want = assign_step_ref(c, a, lam1, lam2, N)

    launchers = {}
    for name in procs:
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).assign_step_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launchers[name] = fn

    def call(fn):
        rc = fn(c.data_ptr(), a.data_ptr(), lam1.data_ptr(), lam2.data_ptr(),
                x.data_ptr(), part.data_ptr(), ticket.data_ptr(),
                out.data_ptr(), N, M, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"assign_step_ablation: launch error {rc}")

    for name in ("kernel", "fenced"):
        x.fill_(-1)
        out.fill_(float("nan"))
        call(launchers[name])
        torch.cuda.synchronize()
        got = (x, out[2:], out[0], out[1])
        if not (all(bool(torch.equal(g, w)) for g, w in zip(got, want))
                and int(ticket.item()) == 0):
            raise SystemExit(f"assign_step_ablation: {name} differs from "
                             f"assign_step_ref or left its ticket set")
    print("checks: kernel and fenced = assign_step_ref bit for bit, ticket "
          "back at 0", flush=True)

    us = {name: [] for name in ["floor"] + list(launchers)}
    for _ in range(args.rounds):
        us["floor"].append(launch_floor_ms(torch, dev) * 1e3)
        for name, fn in launchers.items():
            us[name].append(graph_ms(torch, lambda: call(fn)) * 1e3)
    for name, vals in us.items():
        print(f"{name}: " + ", ".join(f"{v:.3f}" for v in vals) + " us",
              flush=True)
    print(json.dumps({"card": card, "n": N, "m": M, "us": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
