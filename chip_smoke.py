#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the routing plane on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds both hand-written CUDA kernels from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version at the main path's shapes,
routes a 16,384-query batch (quality and budget mode) and four 4,096-query
streaming windows through ``repro_torch.core.OmniRouter`` over a
131,072-row vector store with the ECCOS-H predictor at its default widths
(random encoder weights from a fixed seed), checks the launch counters and
the results, and prints one JSON line of kernel figures, the card's name and
power limit, and a last JSON line ``{"ok": true, "device": {...}}``.  It
exits non-zero without a result when no CUDA device is present or the
package is missing.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_DB = 131_072          # vector store rows (top of BENCH_retrieval's grid)
N_ROUTE = 16_384        # route batch (top of BENCH_routing's grid)
N_WINDOW = 4_096        # streaming window
N_WINDOWS = 4
CMP_QUERIES = 1_024     # plain vote's (queries, N_db) block: 512 MiB
REPS = 20               # timed kernel launches (median)
H100_FP32 = 67e12       # FLOP/s outside the tensor cores (H100 SXM sheet)
H100_HBM = 3.35e12      # bytes/s
H100_SMS = 132
PROBE_REPS = 200        # L2 probe: reads of the dual solve's (N, 2M) bytes


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside the "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")

    from repro_torch.core import (HybridPredictor, OmniRouter, RouterConfig,
                                  evaluate_assignment, featurize_tokens)
    from repro_torch.data import tokenizer
    from repro_torch.data.qaserve import generate
    from repro_torch.kernels import _build
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.lagrangian_assign.kernel import (
        dual_solve_cuda, l2_read_probe_cuda)
    from repro_torch.kernels.lagrangian_assign.ref import fused_dual_solve_ref
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    from repro_torch.kernels.topk_retrieval.kernel import retrieval_vote_cuda
    from repro_torch.kernels.topk_retrieval.ref import retrieval_vote_ref

    def say(*parts):
        print(*parts, flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False   # plain vote in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # 1. device
    card = gpu_line()
    say("device:", card, "| torch", torch.__version__, "cuda",
        torch.version.cuda, "| python", sys.version.split()[0])

    # 2. build both kernels, one nvcc each, in parallel
    t0 = time.perf_counter()
    logs = _build.build_all()
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    # data: the store's history, the route batch and the stream windows
    t0 = time.perf_counter()
    store_ds = generate(n=N_DB, seed=0)
    route_ds = generate(n=N_ROUTE, seed=1)
    win_ds = generate(n=N_WINDOW * N_WINDOWS, seed=2)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    hp = HybridPredictor(seed=0, device=dev).fit_store(store_ds)
    torch.cuda.synchronize()
    say(f"data: generate {t_gen:.2f} s, tokenize+embed store "
        f"{time.perf_counter() - t0:.2f} s; store {hp.retrieval.vstore.size}"
        f" rows x {hp.retrieval.d}, k={hp.hcfg.k}")
    m = route_ds.m
    emb, labels, n_valid, proj = hp.retrieval.device_inputs()
    toks = torch.as_tensor(tokenizer.encode_batch(route_ds.queries, 64),
                           device=dev)
    q_route = featurize_tokens(toks, proj).contiguous()
    k = hp.hcfg.k
    rows = {}

    # 3a. retrieval vote vs its plain version
    def vote_case(store, labs, q, kk, nv, exact=False, tag=""):
        kv, ki, kvo = retrieval_vote_cuda(store, labs, q, kk, nv)
        torch.cuda.synchronize()
        rv, ri, rvo = retrieval_vote_ref(store, labs, q, kk, nv)
        err_v = (kv - rv).abs().max().item()
        same_rows = (torch.sort(ki, 1).values
                     == torch.sort(ri, 1).values).all(1)
        agree = (torch.sort(ki, 1).values
                 == torch.sort(ri, 1).values).float().mean().item()
        # votes hold output lengths (up to 1024) beside 0/1 correctness:
        # 1e-5 relative to max(1, |vote|), one float32 ulp at 1024 is 6e-5
        dvote = (kvo - rvo)[same_rows].abs()
        scale = torch.clamp(rvo[same_rows].abs(), min=1.0)
        err_vote = dvote.max().item() if same_rows.any() else 0.0
        rel_vote = (dvote / scale).max().item() if same_rows.any() else 0.0
        say(f"vote {tag}: B={q.shape[0]} N_db={store.shape[0]} k={kk} "
            f"n_valid={nv} | max|dvals|={err_v:.3g} idx agree={agree:.6f} "
            f"max|dvote|={err_vote:.3g} (relative {rel_vote:.3g})")
        check(err_v <= 1e-5, f"vote {tag} vals")
        check(agree >= 0.999, f"vote {tag} idx sets")
        check(rel_vote <= 1e-5, f"vote {tag} votes")
        if exact:
            check(bool((ki == ri).all()), f"vote {tag} exact idx order")
        return max(err_v, err_vote)

    q_cmp = q_route[:CMP_QUERIES]
    vote_err = max(
        vote_case(emb, labels, q_cmp, k, n_valid, tag="full store"),
        vote_case(emb, labels, q_cmp, 16, 100_003, tag="n_valid"),
        vote_case(emb[:10].contiguous(), labels[:10].contiguous(), q_cmp, 16,
                  10, tag="k>n_valid"))
    dup = torch.cat([emb[:4096], emb[:4096]]).contiguous()
    dup_lab = torch.cat([labels[:4096], labels[:4096]]).contiguous()
    vote_err = max(vote_err, vote_case(dup, dup_lab, q_cmp, 16, 8192,
                                       exact=True, tag="duplicated rows"))

    ms = time_ms(torch, lambda: retrieval_vote_cuda(emb, labels, q_route, k,
                                                    n_valid), REPS)
    plain_ms = time_ms(torch, lambda: retrieval_vote_ref(
        emb, labels, q_route, k, n_valid), 3, warm=1)
    store_t = emb[:n_valid].T
    lib_ms = time_ms(torch, lambda: torch.matmul(q_route, store_t), REPS)
    n_lab = labels.shape[1]
    d = emb.shape[1]
    v_bytes = 4 * (n_valid * d + n_valid * n_lab + N_ROUTE * d
                   + N_ROUTE * n_lab) + 8 * N_ROUTE * k
    v_ops = 2.0 * N_ROUTE * n_valid * d
    v_bound = max(v_bytes / H100_HBM, v_ops / H100_FP32) * 1e3
    say(f"vote timing (B={N_ROUTE}, N_db={n_valid}, d={d}, k={k}): kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul of the same "
        f"fp32 product {lib_ms:.3f} ms; bound {v_bound:.3f} ms = max("
        f"{v_bytes / 1e6:.1f} MB / 3.35 TB/s, {v_ops / 1e12:.3f} TFLOP / "
        f"67 TFLOP/s fp32) | achieved {v_ops / ms / 1e9:.1f} TFLOP/s")
    rows["retrieval_vote"] = dict(
        name="retrieval_vote", route="cuda",
        source="src/repro_torch/csrc/retrieval_vote.cu",
        replaces="src/repro/kernels/topk_retrieval/kernel.py:185",
        max_abs_err=vote_err, ms=ms, plain_ms=plain_ms, bound_ms=v_bound,
        bound_by="bytes" if v_bytes / H100_HBM > v_ops / H100_FP32
        else "operations", library_ms=lib_ms)
    del store_t

    # 3b. dual solve vs its plain version on the main path's predictions
    with torch.no_grad():
        cap, _, cost = hp.predict_device(
            hp.device_inputs(), torch.as_tensor(
                tokenizer.encode_batch(route_ds.queries, hp.token_len),
                device=dev),
            torch.as_tensor(route_ds.input_len, dtype=torch.float32,
                            device=dev),
            torch.as_tensor(route_ds.price_in, dtype=torch.float32,
                            device=dev),
            torch.as_tensor(route_ds.price_out, dtype=torch.float32,
                            device=dev))
    loads = torch.full((m,), float(int(0.3 * N_ROUTE)), device=dev)
    budget = float(cost.min(1).values.sum()) * 1.6
    lam_err = 0.0
    solve_cases = {}
    for mode in ("quality", "budget"):
        thr = 0.75 if mode == "quality" else budget
        cold = dict(mode=mode, lr_con=4.0 if mode == "quality" else 50.0,
                    lr_load=0.5)
        stream = dict(mode=mode, lr_con=3.0, lr_load=0.5, norm_grad=True,
                      stall_tol=1e-2)
        p_cold = la_ops.prepare_problem(cost, cap, thr, loads, **cold)
        p_sc = la_ops.prepare_problem(cost, cap, thr, loads, **stream)
        _, i_sc = la_ops.finish(dual_solve_cuda(*p_sc.args, iters=300,
                                                patience=3), p_sc)
        p_warm = la_ops.prepare_problem(
            cost, cap, thr, loads, lam0=i_sc.lam, lam20=i_sc.lam_load,
            step0=i_sc.iters_run.float(), **stream)
        for case, p, iters in (("cold", p_cold, 150),
                               ("cold stall", p_sc, 300),
                               ("warm", p_warm, 300)):
            out_k = dual_solve_cuda(*p.args, iters=iters, patience=3)
            out_r = fused_dual_solve_ref(*p.args, iters=iters, patience=3)
            xk, ik = la_ops.finish(out_k, p)
            xr, ir = la_ops.finish(out_r, p)
            same_x = bool((xk == xr).all())
            it_k, it_r = int(ik.iters_run), int(ir.iters_run)
            lam_k, lam_r = float(ik.lam), float(ir.lam)
            rel = abs(lam_k - lam_r) / (1.0 + abs(lam_r))
            rel2 = float(((ik.lam_load - ir.lam_load).abs()
                          / (1.0 + ir.lam_load.abs())).max())
            lam_err = max(lam_err, abs(lam_k - lam_r))
            say(f"dual solve {mode} {case}: N={N_ROUTE} M={m} | x equal "
                f"{same_x}, iters_run {it_k}/{it_r}, lam {lam_k:.6g}/"
                f"{lam_r:.6g} (rel {rel:.2g}, lam2 rel {rel2:.2g}), "
                f"feasible {bool(ik.feasible)}")
            check(same_x, f"dual solve {mode} {case}: x")
            check(it_k == it_r, f"dual solve {mode} {case}: iters_run")
            check(rel <= 1e-3 and rel2 <= 1e-3,
                  f"dual solve {mode} {case}: lambda")
            solve_cases[(mode, case)] = (p, iters, it_k)

    p, iters, it_run = solve_cases[("quality", "cold")]
    d_ms = time_ms(torch, lambda: dual_solve_cuda(*p.args, iters=iters,
                                                  patience=3), REPS)
    d_plain = time_ms(torch, lambda: fused_dual_solve_ref(
        *p.args, iters=iters, patience=3), 5, warm=1)
    pw, iters_w, it_w = solve_cases[("quality", "warm")]
    d_warm = time_ms(torch, lambda: dual_solve_cuda(*pw.args, iters=iters_w,
                                                    patience=3), REPS)
    d_bytes = 4 * (N_ROUTE * 2 * m + 6 + 2 * m + 8 + 3 * m)
    d_ops = float(it_run) * N_ROUTE * (4 * m + 1)
    d_bound = max(d_bytes / H100_HBM, d_ops / H100_FP32) * 1e3
    # The design's own bound: one CTA re-reads the (N, 2M) problem from L2
    # every iteration, so each iteration takes at least its bytes over one
    # SM's L2 read rate (measured by the probe) or its operations over one
    # SM's share of the fp32 rate, plus the fixed cost of the iteration's
    # barriers, reductions and thread-0 bookkeeping (measured as the
    # kernel's time per iteration at one row per thread, less that row's
    # bytes).
    ab_bytes = 4 * N_ROUTE * 2 * m
    probe = torch.rand(N_ROUTE * 2 * m, device=dev)
    probe_ms = time_ms(torch, lambda: l2_read_probe_cuda(probe, PROBE_REPS),
                       REPS)
    sm_l2 = ab_bytes * PROBE_REPS / (probe_ms * 1e-3)            # bytes/s
    rows_1 = slice(0, 1024)
    args_1 = (p.args[0][rows_1], p.args[1][rows_1], *p.args[2:])
    small_ms = time_ms(torch, lambda: dual_solve_cuda(*args_1, iters=iters,
                                                      patience=3), REPS)
    t_fixed = max(small_ms * 1e-3 / iters - 4 * 1024 * 2 * m / sm_l2, 0.0)
    sm_fp32 = H100_FP32 / H100_SMS
    per_iter = max(ab_bytes / sm_l2, N_ROUTE * (4 * m + 1) / sm_fp32)
    d_design = it_run * (per_iter + t_fixed) * 1e3
    say(f"dual solve timing (quality, cold, N={N_ROUTE}, M={m}, {it_run} "
        f"iterations): kernel {d_ms:.3f} ms ({d_ms * 1e3 / max(it_run, 1):.2f}"
        f" us/iteration, {it_run * ab_bytes / d_ms / 1e6:.1f} GB/s"
        f" of A|B re-read), plain {d_plain:.3f} ms; warm ({it_w} iterations)"
        f" kernel {d_warm:.3f} ms")
    say(f"dual solve bound of this one-CTA design: {d_design:.3f} ms = "
        f"{it_run} x (max({ab_bytes / 1e3:.0f} KB / {sm_l2 / 1e9:.1f} GB/s "
        f"one-SM L2 read [probe: {PROBE_REPS} reads in {probe_ms:.3f} ms], "
        f"{N_ROUTE * (4 * m + 1) / 1e3:.0f} kFLOP / "
        f"{sm_fp32 / 1e12:.3f} TFLOP/s one SM's fp32) + {t_fixed * 1e6:.2f} "
        f"us fixed per iteration [1,024 rows: {small_ms:.3f} ms for {iters}]"
        f"); kernel at {d_design / d_ms:.1%} of it")
    say(f"dual solve whole-card floor (a multi-CTA design): "
        f"{d_bound * 1e3:.2f} us = max({d_bytes / 1e3:.0f} KB / 3.35 TB/s, "
        f"{d_ops / 1e6:.1f} MFLOP [iters x N x (4M+1)] / 67 TFLOP/s)")
    del probe
    rows["dual_solve"] = dict(
        name="dual_solve", route="cuda",
        source="src/repro_torch/csrc/dual_solve.cu",
        replaces="src/repro/kernels/lagrangian_assign/kernel.py:251",
        max_abs_err=lam_err, ms=d_ms, plain_ms=d_plain, bound_ms=d_bound,
        bound_by="bytes" if d_bytes / H100_HBM > d_ops / H100_FP32
        else "operations", library_ms=None, design_bound_ms=d_design)

    # 4. the main path: route (both modes) and streaming windows
    tr_ops.launches = 0
    la_ops.launches = 0
    per_phase = {}

    def report(tag, ds, x, router, avail):
        res = evaluate_assignment(ds, x)
        counts = np.bincount(x, minlength=m)
        tm = router.last_timing
        say(f"{tag}: SR={res['success_rate']:.4f} $={res['cost']:.6f} "
            f"counts={counts.tolist()} loads={np.asarray(avail).tolist()} | "
            f"tokenize {tm['tokenize_s'] * 1e3:.1f} ms, predict+solve "
            f"{tm['predict_solve_s'] * 1e3:.1f} ms, polish "
            f"{tm['polish_s'] * 1e3:.1f} ms | moves: repair "
            f"{tm.get('repair_moves', 0)}, polish phase0 "
            f"{tm.get('polish_phase0_moves', 0)}, phase1 "
            f"{tm.get('polish_phase1_moves', 0)}")
        check(x.shape == (ds.n,) and x.min() >= 0 and x.max() < m,
              f"{tag}: assignment shape/range")
        check(bool(np.all(counts <= np.asarray(avail))),
              f"{tag}: a per-model count exceeds its load")

    def launches():
        return tr_ops.launches, la_ops.launches

    before = launches()
    # integer loads: with a fractional load the reference repair moves a
    # query onto a model "with room" (count < 4915.2) and overloads it
    batch = route_ds.route_batch(np.full(m, float(int(0.3 * N_ROUTE))))
    router_q = OmniRouter(hp, RouterConfig(alpha=0.75))
    report("route quality", route_ds, router_q.route(batch), router_q,
           batch.available)
    per_phase["route quality"] = [a - b for a, b in zip(launches(), before)]

    before = launches()
    router_b = OmniRouter(hp, RouterConfig(alpha=0.75, budget=budget))
    xb = router_b.route(batch)
    report(f"route budget (B={budget:.4f} predicted $)", route_ds, xb,
           router_b, batch.available)
    per_phase["route budget"] = [a - b for a, b in zip(launches(), before)]

    before = launches()
    router_s = OmniRouter(hp, RouterConfig(alpha=0.75))
    state = None
    for w in range(N_WINDOWS):
        wds = win_ds.subset(np.arange(w * N_WINDOW, (w + 1) * N_WINDOW))
        wb = wds.route_batch(np.full(m, float(int(0.3 * N_WINDOW))))
        xw, state = router_s.route_window(wb, state,
                                          share=1.0 / (N_WINDOWS - w))
        report(f"window {w}", wds, xw, router_s, wb.available)
    say(f"windows: dual iters {router_s.dual_iters}, ledger spent "
        f"{float(state.budget_spent):.6f} $, deficit "
        f"{float(state.sr_deficit):.4f}, steps {float(state.steps):.0f}")
    per_phase["windows"] = [a - b for a, b in zip(launches(), before)]
    vote_launches, solve_launches = launches()
    say(f"launches on the main path (vote, dual solve): {per_phase}")
    for tag, (nv_, ns_) in per_phase.items():
        check(nv_ > 0 and ns_ > 0, f"{tag}: a kernel was not launched")
    rows["retrieval_vote"]["launches"] = vote_launches
    rows["dual_solve"]["launches"] = solve_launches

    # 5. agreement with the plain (CPU) path on a small input
    small_store = store_ds.subset(np.arange(2048))
    small = route_ds.subset(np.arange(512))
    # the same weights, copied to the host (PredictorNet moves them)
    hp_cpu = HybridPredictor(params=hp.trained.params, device="cpu"
                             ).fit_store(small_store)
    hp_gpu = HybridPredictor(params=hp.trained.params, device=dev
                             ).fit_store(small_store)
    sb = small.route_batch(np.full(m, float(int(0.3 * small.n))))
    x_cpu = OmniRouter(hp_cpu, RouterConfig(alpha=0.75)).route(sb)
    x_gpu = OmniRouter(hp_gpu, RouterConfig(alpha=0.75)).route(sb)
    agree = float((x_cpu == x_gpu).mean())
    r_cpu, r_gpu = (evaluate_assignment(small, x_cpu),
                    evaluate_assignment(small, x_gpu))
    say(f"small input (512 queries, 2048-row store): card vs CPU plain path "
        f"agree on {agree:.4f} of rows; SR {r_gpu['success_rate']:.4f} vs "
        f"{r_cpu['success_rate']:.4f}, $ {r_gpu['cost']:.6f} vs "
        f"{r_cpu['cost']:.6f}")
    check(agree >= 0.95, "card and CPU routes disagree on the small input")
    check(abs(r_gpu["success_rate"] - r_cpu["success_rate"]) <= 0.02,
          "card and CPU success rates differ")

    say(f"total {time.perf_counter() - t_all:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernels = [rows["retrieval_vote"], rows["dual_solve"]]
    for r in kernels:
        check(set(r) >= {"name", "route", "source", "replaces", "launches",
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms"}, f"{r['name']}: keys")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
