#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (routing plane and paged serving plane) on
one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the three hand-written CUDA kernels from ``src/repro_torch/csrc``
(one ``nvcc`` each, in parallel) and holds each against its plain PyTorch
version at the main path's shapes.

Routing plane: it routes a 16,384-query batch (quality and budget mode) and
four 4,096-query streaming windows through ``repro_torch.core.OmniRouter``
over a 131,072-row vector store with the ECCOS-H predictor at its default
widths (random encoder weights from a fixed seed).

Serving plane: the paged decode kernel against its plain version at
h2o-danube-3-4b's and gemma3-4b's head shapes; h2o-danube-3-4b at full width
and depth (random weights from a fixed seed, wq and wk rescaled to unit-std
attention scores) decoding 32 teacher-forced steps against its
full-sequence logits in float32 and in bf16; one full-width ``Endpoint`` serving
16 requests x 128 tokens (prefill, decode-chunk and kernel timings); a
routed ``MultiLLMServer`` of four endpoints behind the port's
``OmniRouter``; and an all-smoke float32 pool served on the card and on the
CPU with the same result.

It checks the launch counters and the results, and prints one JSON line of
kernel figures, the card's name and power limit, and a last JSON line
``{"ok": true, "device": {...}}``.  It exits non-zero without a result when
no CUDA device is present or the package is missing.
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


# -- serving plane ------------------------------------------------------------

# Full-width check.  Under the reference's random init (the "scaled" rule
# takes fan-in from shape[-2], the head count for wq and wk, so q and k
# come out with stds of ~11 and ~22) attention scores have a std of ~240
# and the softmax is nearly an argmax: a rounding-sized difference between
# two paths grows by an order of magnitude or more per layer, and after 24
# layers two paths decode unrelated logits.  The script shows that on the
# stock weights in float32 with the plain version in the kernel's place as
# well (the chaos witness: reported, not checked).  The checked comparison
# rescales wq and wk to fan-in d_model (unit-std scores; every other weight
# as drawn) and holds the full depth in float32 and in bf16 to these
# limits.  Float32: both paths compute the same function up to float32
# summation order; a wrong mask, page or position gives differences of the
# order of the logits.  bf16: the full-sequence logits are rounded to bf16
# (2**-9 relative) and each layer's activations round at other points on
# the two paths (the prefill attention rounds p to bf16, the kernel keeps
# it in float32).
FULL_LIMITS = {"float32": (1e-3, 0.99), "bf16": (5e-2, 0.90)}
# (tag, B, K, G, D, page size, pages per sequence, window, largest lens, dtype)
KV_CASES = [
    ("danube heads", 16, 8, 4, 120, 16, 128, 0, 2048, "bfloat16"),
    ("danube heads, window 4096", 16, 8, 4, 120, 16, 288, 4096, 4600,
     "bfloat16"),
    ("gemma3-4b heads, window 1024", 16, 4, 2, 256, 16, 128, 1024, 2048,
     "bfloat16"),
    ("small float32", 3, 2, 4, 64, 16, 8, 24, 128, "float32"),
]
CHECK_STEPS = 32        # teacher-forced decode steps of the full-width check
ENDPOINT_REQS = 16      # full-width endpoint: requests, prompt range, output
PROMPT_LO, PROMPT_HI, MAX_NEW = 256, 1536, 128
ROUTED_REQS = 48
CPU_REQS = 24
SMOKE_POOL = ("h2o-danube-3-4b", "internlm2-20b", "qwen2-72b", "gemma3-4b")


def paged_inputs(torch, b, kh, g, d, ps, p, lens_max, dtype, dev, seed):
    """Random q and pools on the card, a block table of shuffled physical
    pages (page 0 the dump page, unused entries 0) and ragged lens that
    include 1 and P·PS."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + b * p
    q = torch.randn(b, 1, kh * g, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages, ps, kh, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n_pages, ps, kh, d, generator=gen, device=dev).to(dtype)
    cpu = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, lens_max + 1, (b,), generator=cpu)
    lens[0], lens[-1] = 1, min(lens_max, p * ps)
    perm = torch.randperm(n_pages - 1, generator=cpu) + 1
    bt = torch.zeros(b, p, dtype=torch.int32)
    for i in range(b):
        n_used = -(-int(lens[i]) // ps)
        bt[i, :n_used] = perm[i * p:i * p + n_used]
    return q, kp, vp, bt.to(dev), lens.to(torch.int32).to(dev)


def attention_bytes_ops(q, bt, lens, kh, d, window, elem):
    """What one paged decode must move and compute on this data: q and the
    output once, each valid position's K and V row once, the block table and
    lens once; 4·H·D operations per valid position (QK and PV)."""
    b, _, h, _ = q.shape
    n = lens.clamp(min=0).cpu()
    if window > 0:
        n = n.clamp(max=window)
    valid = int(n.sum())
    nbytes = (2 * b * h * d * elem + 2 * valid * kh * d * elem
              + 4 * bt.numel() + 4 * b)
    return nbytes, 4.0 * valid * h * d


def full_width_check(torch, np, model, params, dev, say, check, tag,
                     limits=None, plain=False):
    """Prefill four ragged prompts alone into pages, teacher-force
    CHECK_STEPS paged decode steps (one kernel launch per layer per step;
    with ``plain`` the plain version in the kernel's place), and hold each
    step's logits against the full-sequence logits at the same position
    (to ``limits``, (max relative difference, least argmax agreement), when
    given).  Returns (max|diff| / max|logit|, argmax agreement)."""
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.models.zoo import prefill_into_pages
    cfg = model.cfg
    rng = np.random.RandomState(0)
    plens = [100, 237, 480, 511]
    ps, nb = 16, len(plens)
    p_max = -(-(max(plens) + CHECK_STEPS) // ps)
    seqs = [rng.randint(1, cfg.vocab_size, (n + CHECK_STEPS,)) for n in plens]
    state = model.empty_paged_state(nb, 1 + nb * p_max, ps, device=dev)
    bt = torch.arange(1, 1 + nb * p_max, dtype=torch.int32,
                      device=dev).reshape(nb, p_max)
    for i, n in enumerate(plens):
        cache, _ = model.prefill(params, torch.as_tensor(seqs[i][None, :n],
                                                         device=dev))
        prefill_into_pages(state, cache, bt[i, :-(-n // ps)].long(), i, ps)
    lens = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    dec = []
    kernel_fn = pd_ops.paged_decode_attention
    if plain:
        pd_ops.paged_decode_attention = paged_decode_attention_ref
    pd_ops.launches = 0
    try:
        for t in range(CHECK_STEPS):
            tok = torch.as_tensor(np.array([[s[n + t]] for s, n in
                                            zip(seqs, plens)]),
                                  dtype=torch.int32, device=dev)
            _, lg = model.decode_step_paged(params, state, tok, bt, lens)
            dec.append(lg[:, :cfg.vocab_size])
            lens = lens + 1
    finally:
        pd_ops.paged_decode_attention = kernel_fn
    full = [model.logits(params, torch.as_tensor(s[None], device=dev))[
        0, :, :cfg.vocab_size] for s in seqs]
    torch.cuda.synchronize()
    check(pd_ops.launches == (0 if plain else cfg.n_layers * CHECK_STEPS),
          f"full-width check ({tag}): one kernel launch per layer per step")
    dec = torch.stack(dec, dim=1)                        # (B, steps, V)
    ref = torch.stack([f[n:n + CHECK_STEPS] for f, n in zip(full, plens)])
    check(bool(torch.isfinite(dec).all() and torch.isfinite(ref).all()),
          f"full-width check ({tag}): non-finite logits")
    rel = float((dec - ref).abs().max() / ref.abs().max())
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    say(f"danube full width {tag}, {nb} sequences (prompts {plens}) x "
        f"{CHECK_STEPS} teacher-forced paged decode steps "
        f"({'plain version' if plain else 'kernel'}) vs full-sequence "
        f"logits: max|diff|/max|logit| = {rel:.4g}, argmax agreement "
        f"{agree:.4f}" + (f" (limits: <= {limits[0]}, >= {limits[1]})"
                          if limits else " (reported)"))
    if limits:
        check(rel <= limits[0] and agree >= limits[1],
              f"full-width check ({tag}): decode disagrees with the full "
              "sequence")
    return rel, agree


def _unit_scores(tree):
    """The tree with wq and wk rescaled from the init's fan-in (shape[-2],
    the head count) to fan-in d_model: q and k of unit std, so attention
    scores of unit std.  New wq/wk tensors; every other leaf is shared."""
    import math
    segs = []
    for seg in tree["segs"]:
        layers = []
        for layer in seg:
            attn = dict(layer["attn"])
            for key in ("wq", "wk"):
                w = attn[key]                        # (count, d, heads, hd)
                attn[key] = w * math.sqrt(w.shape[-2] / w.shape[1])
            layers.append(dict(layer, attn=attn))
        segs.append(layers)
    return dict(tree, segs=segs)


def serving_plane(torch, np, dev, say, check, time_ms):
    """The serving-plane phases; returns the kernels-line row of the paged
    decode kernel."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import (BalanceAware, HybridPredictor, OmniRouter,
                                  PredictorConfig, RouterConfig)
    from repro_torch.data.qaserve import DEFAULT_POOL, generate
    from repro_torch.data.tokenizer import encode_for_config
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.decode_attention.kernel import (
        paged_decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import (
        gather_pages, paged_decode_attention_ref)
    from repro_torch.models import build_model
    from repro_torch.serving.engine import (Endpoint, MultiLLMServer, Request,
                                            null_route_features)
    import dataclasses
    import torch.nn.functional as F

    # S2. the paged decode kernel against its plain version.  bf16: both
    # compute in float32 and round the output to bf16 once, so they agree
    # to one bf16 ulp (2**-7 relative) plus 1e-5; float32: the reference's
    # own 2e-5.
    pd_err = 0.0
    for tag, b, kh, g, d, ps, p, window, lmax, dt in KV_CASES:
        dtype = getattr(torch, dt)
        q, kp, vp, bt, lens = paged_inputs(torch, b, kh, g, d, ps, p, lmax,
                                           dtype, dev, seed=len(tag))
        got = paged_decode_attention_cuda(q, kp, vp, bt, lens, window=window)
        torch.cuda.synchronize()
        want = paged_decode_attention_ref(q, kp, vp, bt, lens, window=window)
        err = (got.float() - want.float()).abs()
        if dt == "float32":
            ok = float(err.max()) <= 2e-5
        else:
            ok = torch.allclose(got.float(), want.float(), atol=1e-5,
                                rtol=2 ** -7)
        pd_err = max(pd_err, float(err.max()))
        say(f"paged decode {tag}: B={b} K={kh} G={g} D={d} PS={ps} P={p} "
            f"window={window} lens {int(lens.min())}..{int(lens.max())} "
            f"{dt} | max|kernel-plain|={float(err.max()):.3g}")
        check(ok, f"paged decode {tag}: kernel disagrees with plain version")

    # S3. full-width h2o-danube-3-4b: 32 teacher-forced paged decode steps
    # (the kernel) against the full-sequence logits (prefill attention), all
    # 24 layers: the stock weights in float32 with the kernel and with the
    # plain version (the chaos witness, reported), then unit-std attention
    # scores in float32 and in bf16, the serving dtype (checked)
    cfg = get_config("h2o-danube-3-4b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    say(f"danube full width: {cfg.n_layers} layers d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} ff={cfg.d_ff} "
        f"V={cfg.vocab_size} window={cfg.sliding_window}; {n_par / 1e9:.3f} "
        f"B params ({n_par * 2 / 1e9:.2f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    params32 = _tree_to(params, torch.float32)
    for plain in (False, True):
        full_width_check(torch, np, model32, params32, dev, say, check,
                         "float32, stock weights", plain=plain)
    full_width_check(torch, np, model32, _unit_scores(params32), dev, say,
                     check, "float32, unit-std scores",
                     limits=FULL_LIMITS["float32"])
    del params32
    full_width_check(torch, np, model, _unit_scores(params), dev, say, check,
                     "bf16, unit-std scores", limits=FULL_LIMITS["bf16"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"peak device memory up to here {peak:.2f} GiB (the float32 checks "
        f"hold both trees)")

    # S4. one full-width endpoint: 16 requests x 128 tokens
    torch.cuda.reset_peak_memory_stats()
    ep = Endpoint(cfg, max_concurrency=ENDPOINT_REQS, t_max=2048,
                  page_size=16, sync_every=8, params=params, device=dev)
    rng = np.random.RandomState(0)
    reqs = [Request(i, rng.randint(1, cfg.vocab_size,
                                   (int(rng.randint(PROMPT_LO,
                                                    PROMPT_HI + 1)),)
                                   ).astype(np.int32), max_new=MAX_NEW)
            for i in range(ENDPOINT_REQS)]
    pd_ops.launches = 0
    pre_ms = []
    for r in reqs:
        t0 = time.perf_counter()
        ep.admit(r)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    snap = (torch.as_tensor(ep.block_table, device=dev),
            torch.as_tensor(ep.lens + 1, device=dev))
    chunk_ms, begin_ms, done = [], [], []
    while ep.active_count():
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")     # step_begin never syncs
        try:
            pending = ep.step_begin()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        begin_ms.append((time.perf_counter() - t0) * 1e3)
        done += ep.step_end(pending)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    ep_launches = pd_ops.launches
    steps = ep.busy_steps * ep.sync_every
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(done) == ENDPOINT_REQS
          and all(len(r.output) == MAX_NEW for r in done),
          "endpoint: not every request got 128 tokens")
    check(len(ep.alloc.free_pages) == ep.alloc.n_pages - 1
          and len(ep.alloc.free_slots) == ep.L, "endpoint: allocator leak")
    check(ep.batch_reprefills == 0, "endpoint: batch re-prefill")
    check(ep_launches == cfg.n_layers * steps,
          "endpoint: kernel launches != 24 per decode step")
    steady = chunk_ms[1:] or chunk_ms
    chunk_med = float(np.median(steady))
    say(f"endpoint (danube full width, L={ep.L}, t_max={ep.t_max}, PS=16, "
        f"sync_every=8, {ep.alloc.n_pages} pages): {ENDPOINT_REQS} requests, "
        f"prompts {min(len(r.tokens) for r in reqs)}..{max(len(r.tokens) for r in reqs)}, "
        f"{MAX_NEW} tokens each | prefill {np.median(pre_ms):.1f} ms/request "
        f"(median; {min(pre_ms):.1f}..{max(pre_ms):.1f}) | decode chunk "
        f"{chunk_med:.1f} ms median ({len(chunk_ms)} chunks, first "
        f"{chunk_ms[0]:.1f} ms), {ep.L * ep.sync_every / chunk_med * 1e3:.1f}"
        f" tokens/s, step_begin dispatch {np.median(begin_ms):.1f} ms | "
        f"kernel launches {ep_launches} = {cfg.n_layers} x {steps} steps | "
        f"peak {peak:.2f} GiB")

    # the kernel at the endpoint's lens (after admission: prompts + 1)
    k_pool = ep._state["segs"][0][0]["k"][0]
    v_pool = ep._state["segs"][0][0]["v"][0]
    bt_e, lens_e = snap
    gen = torch.Generator(device=dev).manual_seed(5)
    q_e = torch.randn(ENDPOINT_REQS, 1, cfg.n_heads, cfg.hd, generator=gen,
                      device=dev).to(cfg.dtype)
    window = cfg.sliding_window
    k_ms = time_ms(torch, lambda: paged_decode_attention_cuda(
        q_e, k_pool, v_pool, bt_e, lens_e, window=window), 50)
    p_ms = time_ms(torch, lambda: paged_decode_attention_ref(
        q_e, k_pool, v_pool, bt_e, lens_e, window=window), 10)
    kd = gather_pages(k_pool, bt_e).transpose(1, 2).contiguous()
    vd = gather_pages(v_pool, bt_e).transpose(1, 2).contiguous()
    qd = q_e.transpose(1, 2).contiguous()
    try:
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, enable_gqa=True), 50)
    except TypeError as exc:          # a PyTorch without enable_gqa
        say(f"  SDPA with enable_gqa unavailable: {exc}")
        lib_ms = None
    del kd, vd
    nbytes, nops = attention_bytes_ops(q_e, bt_e, lens_e, cfg.n_kv_heads,
                                       cfg.hd, window, 2)
    bound = max(nbytes / H100_HBM, nops / H100_FP32) * 1e3
    share = k_ms * cfg.n_layers / (chunk_med / ep.sync_every)
    say(f"paged decode kernel at the endpoint's lens (B={ENDPOINT_REQS}, "
        f"lens {int(lens_e.min())}..{int(lens_e.max())}, P="
        f"{bt_e.shape[1]}): {k_ms * 1e3:.1f} us/launch, bound "
        f"{bound * 1e3:.1f} us = max({nbytes / 1e6:.2f} MB / 3.35 TB/s, "
        f"{nops / 1e9:.3f} GFLOP / 67 TFLOP/s fp32) -> {bound / k_ms:.1%} "
        f"of it; plain {p_ms * 1e3:.1f} us; SDPA over the pre-gathered dense"
        f" K/V (all {bt_e.shape[1] * 16} positions, gather excluded) "
        + (f"{lib_ms * 1e3:.1f} us" if lib_ms is not None else "n/a")
        + f"; {cfg.n_layers} launches = {share:.1%} of a decode step")
    row = dict(name="paged_decode_attention", route="cuda",
               source="src/repro_torch/csrc/paged_decode.cu",
               replaces="src/repro/kernels/decode_attention/kernel.py:197",
               max_abs_err=pd_err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
               bound_by="bytes" if nbytes / H100_HBM > nops / H100_FP32
               else "operations", library_ms=lib_ms)
    del ep, k_pool, v_pool

    # S5. routed server: full-width danube + three smoke endpoints behind
    # the port's OmniRouter (stream=False)
    pool = DEFAULT_POOL[:4]
    smoke = [get_smoke_config(a) for a in SMOKE_POOL[1:]]
    eps = [Endpoint(cfg, max_concurrency=4, t_max=128, page_size=16,
                    sync_every=8, params=params, device=dev)]
    eps += [Endpoint(c, max_concurrency=4, t_max=128, page_size=16,
                     sync_every=8, seed=i + 1, device=dev)
            for i, c in enumerate(smoke)]
    hp = HybridPredictor(PredictorConfig(n_models=4), seed=0, device=dev
                         ).fit_store(generate(n=8192, seed=0, pool=pool))
    router = OmniRouter(hp, RouterConfig(alpha=0.75))
    ds = generate(n=ROUTED_REQS, seed=3, pool=pool)
    small_vocab = min([cfg] + smoke, key=lambda c: c.vocab_size)
    srv = MultiLLMServer(eps, router)
    for rid, text in enumerate(ds.queries):
        srv.submit(Request(rid, encode_for_config(small_vocab, text),
                           max_new=16))
    pd_ops.launches = 0
    t0 = time.perf_counter()
    served = srv.run(lambda b: ds.subset(np.array([r.rid for r in b])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routed_launches = pd_ops.launches
    per_ep = np.bincount([r.endpoint for r in served], minlength=4)
    say(f"routed server (danube full width + {', '.join(c.name for c in smoke)};"
        f" OmniRouter over a 8,192-row store): {len(served)}/{ROUTED_REQS} "
        f"served, per endpoint {per_ep.tolist()}, {srv.route_calls} route "
        f"calls in {srv.route_seconds:.3f} s, wall {wall:.2f} s, kernel "
        f"launches {routed_launches}")
    check(len(served) == ROUTED_REQS and all(
        r.done and len(r.output) == 16 for r in served),
          "routed server: not every request served")
    check(bool((per_ep > 0).all()), "routed server: an endpoint served none")
    check(routed_launches > 0, "routed server: the kernel never ran")
    del eps, srv, params

    # S6. the all-smoke float32 pool behind BalanceAware, card vs CPU
    cfgs = [dataclasses.replace(get_smoke_config(a), dtype=torch.float32)
            for a in SMOKE_POOL]
    host = [build_model(c).init(i, "cpu") for i, c in enumerate(cfgs)]
    rng = np.random.RandomState(7)
    todo = [(rng.randint(1, 512, (int(rng.randint(2, 40)),)).astype(np.int32),
             int(rng.randint(4, 17))) for _ in range(CPU_REQS)]
    runs = []
    for where in (dev, torch.device("cpu")):
        eps = [Endpoint(c, max_concurrency=3, t_max=64, page_size=8,
                        sync_every=4, device=where,
                        params=_tree_to(host[i], where))
               for i, c in enumerate(cfgs)]
        srv = MultiLLMServer(eps, BalanceAware())
        for rid, (toks, m) in enumerate(todo):
            srv.submit(Request(rid, toks, max_new=m))
        runs.append({r.rid: (r.endpoint, list(r.output))
                     for r in srv.run(null_route_features)})
    card, host_run = runs
    same_ep = np.mean([card[i][0] == host_run[i][0] for i in range(CPU_REQS)])
    same_out = np.mean([card[i] == host_run[i] for i in range(CPU_REQS)])
    say(f"smoke pool float32, card vs CPU ({CPU_REQS} requests): same "
        f"endpoint {same_ep:.4f}, same (endpoint, output) {same_out:.4f}")
    check(len(card) == len(host_run) == CPU_REQS,
          "card vs CPU: a request was lost")
    check(same_ep >= 0.95 and same_out >= 0.95,
          "card vs CPU: outputs differ on more than 5% of requests")
    row["launches"] = ep_launches + routed_launches
    say(f"paged decode launches on the main path: endpoint {ep_launches}, "
        f"routed server {routed_launches}")
    return row


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_to(tree, where):
    """The tree on another device or in another dtype (``Tensor.to``)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, where) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, where) for v in tree]
    return tree.to(where)


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

    del hp, hp_cpu, hp_gpu, emb, labels, proj, q_route
    rows["paged_decode_attention"] = serving_plane(
        torch, np, dev, say, check, time_ms)

    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"total {time.perf_counter() - t_all:.1f} s; peak device memory "
        f"since the endpoint phase {peak:.2f} GiB")
    kernels = [rows["retrieval_vote"], rows["dual_solve"],
               rows["paged_decode_attention"]]
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
