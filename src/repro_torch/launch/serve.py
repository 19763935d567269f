"""Serving launcher: ECCOS/OmniRouter in front of a multi-arch pool.

The port of ``repro.launch.serve``, with the same flags, defaults, pool,
dataset, router and printed lines.  CPU demo (smoke configs, real models
decoding):

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 \\
        --mode batching --device cpu

Streaming control plane: requests arrive over the decode clock and the
router runs as a persistent dual controller —

    PYTHONPATH=src python -m repro_torch.launch.serve --arrival poisson \\
        --arrival-rate 4 --stream --device cpu

It serves on the CUDA device unless ``--device cpu`` names the CPU (no
fallback: without a card it stops).  ``--full ARCH[,ARCH...]`` builds
those pool members from their published configs (``get_config``) instead
of the smoke configs, at full width and depth with random bf16 weights:
the full configs on hardware that the reference's docstring promises.  On
one 80 GB card the pool's five smaller members fit together
(``--full h2o-danube-3-4b,internlm2-20b,gemma3-4b,hymba-1.5b,xlstm-350m``,
29.4 B parameters); qwen2-72b's 145 GB of bf16 weights do not.

The reference's per-endpoint "compiles" (XLA traces) have no eager
counterpart and are not printed; CUDA-graph captures of the decode chunk
would be its analogue, and the port does not capture the chunk yet.
``main(argv)`` returns what it printed: the served count, SR and $, each
request's endpoint, and each endpoint's requests, tokens, decode chunks
and batch re-prefills, beside the wall time and the route overhead.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common import default_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import OmniRouter, RetrievalPredictor, RouterConfig
from repro_torch.data import arrivals, tokenizer
from repro_torch.data.qaserve import generate
from repro_torch.serving.engine import Endpoint, MultiLLMServer, Request

POOL_ARCHS = ["h2o-danube-3-4b", "internlm2-20b", "qwen2-72b",
              "gemma3-4b", "hymba-1.5b", "xlstm-350m"]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Route requests over a multi-arch pool on one device: "
                    "the CUDA card unless --device cpu.")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--mode", default="batching",
                    choices=["batching", "streaming"])
    ap.add_argument("--alpha", type=float, default=0.75)
    ap.add_argument("--loads", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--arrival", default="batch",
                    choices=sorted(arrivals.GENERATORS))
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="arrivals per decode step (non-batch processes)")
    ap.add_argument("--stream", action="store_true",
                    help="persistent dual controller: warm-started windows, "
                         "cumulative budget/alpha ledger")
    ap.add_argument("--full", default="",
                    help="comma-separated pool members built from their "
                         "published configs (default: none, every member "
                         "at smoke size)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; the CPU "
                         "only when named: --device cpu)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to serve on the "
                         "CPU")
    full = [a for a in args.full.split(",") if a]
    unknown = sorted(set(full) - set(POOL_ARCHS))
    if unknown:
        raise SystemExit(f"--full names {unknown}, not in the pool "
                         f"{POOL_ARCHS}")

    ds = generate(n=600, seed=0)
    train, _, test = ds.split()
    test = test.subset(np.arange(min(args.requests, test.n)))

    router = OmniRouter(RetrievalPredictor(k=8, device=device).fit(train),
                        RouterConfig(alpha=args.alpha), name="ECCOS-R")

    endpoints = [Endpoint(get_config(a) if a in full else get_smoke_config(a),
                          max_concurrency=args.loads, seed=i, device=device)
                 for i, a in enumerate(POOL_ARCHS)]
    server = MultiLLMServer(endpoints, router,
                            batch_size=1 if args.mode == "streaming" else 0,
                            stream=args.stream, horizon=test.n)

    # remap router tokens into the pool's smallest model vocab
    vocab_cfg = min((e.cfg for e in endpoints), key=lambda c: c.vocab_size)
    steps = arrivals.make(args.arrival, test.n, rate=args.arrival_rate, seed=0)
    for i in range(test.n):
        toks = tokenizer.encode_for_config(vocab_cfg, test.queries[i], 32)
        server.submit(Request(rid=i, tokens=toks, max_new=args.max_new),
                      at_step=steps[i])

    t0 = time.time()
    done = server.run(lambda batch: test.subset(
        np.array([r.rid for r in batch])))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0

    assign = np.array([r.endpoint for r in sorted(done, key=lambda r: r.rid)])
    sr = float(test.correct[np.arange(len(assign)), assign].mean())
    cost = float(test.cost_matrix()[np.arange(len(assign)), assign].sum())
    print(f"served {len(done)}/{test.n} requests in {wall:.1f}s "
          f"({args.mode}, arrival={args.arrival}"
          f"{', streaming dual' if args.stream else ''}); "
          f"routed SR={sr:.3f} cost=${cost:.4f}; "
          f"route overhead {server.route_seconds:.3f}s over "
          f"{server.route_calls} windows"
          + (f", {server.dual_iters} dual iters" if args.stream else ""))
    per_endpoint = []
    for j, e in enumerate(endpoints):
        n_j = int((assign == j).sum())
        print(f"  endpoint {j} ({POOL_ARCHS[j]}): {n_j} reqs, "
              f"{e.decoded_tokens} tokens in {e.busy_steps} decode chunks, "
              f"{e.batch_reprefills} batch re-prefills")
        per_endpoint.append(dict(
            arch=POOL_ARCHS[j], full=POOL_ARCHS[j] in full, reqs=n_j,
            tokens=e.decoded_tokens, chunks=e.busy_steps,
            reprefills=e.batch_reprefills))
    return dict(served=len(done), n=test.n,
                rids=sorted(r.rid for r in done), sr=sr, cost=cost,
                endpoint=assign.tolist(), endpoints=per_endpoint,
                wall_s=wall, route_seconds=server.route_seconds,
                windows=server.route_calls, dual_iters=server.dual_iters,
                mode=args.mode, arrival=args.arrival, stream=args.stream)


if __name__ == "__main__":
    main()
