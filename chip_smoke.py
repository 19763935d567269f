#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (routing plane, paged serving plane, the
routed speculative stream, the dense-cache generation path, neighbour-only
top-k retrieval, the seed's per-iteration solve, the serving simulator,
predictor training, the serving engine's failure plane, the sanitizer
plane and runtime guards, int8 KV pools, the recurrent model families,
the MoE family, the encoder-decoder, language-model training, the
serving launcher at full width and the analysis plane, and distribution
on ``torch.distributed`` with four ranks sharing the card) on one NVIDIA
GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the ten hand-written CUDA kernels from ``src/repro_torch/csrc``
(one ``nvcc`` per source, all started together; the paged decode, paged
verify and dense decode kernels share ``paged_decode.cu``, the vote and
top-k kernels ``retrieval_vote.cu``, the shard statistics and the assign
step ``shard_stats.cu``; the flash backward is ``flash_attention_bwd.cu``)
and holds each against its plain PyTorch version at the main path's
shapes.

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

Routed speculative stream: the paged verify kernel against its plain
version and, bit for bit, against the decode kernel (V1); the
shard-statistics kernel against its plain version, the padded, masked
streaming solve on the card (one launch of the blocked dual ascent a
window, no host read) against the CPU bit for bit, and the blocked ascent
kernel against its plain version on every window's inputs (V2); a
(2-layer draft, 24-layer verify) h2o-danube-3-4b pair
at full width decoding speculatively, its output held to the verify model
alone in float32, and a grafted verify model that accepts nearly every draft
(V3); ``MultiLLMServer(stream=True, spec_pairs=...)`` behind the port's
``OmniRouter`` with a pair column, 32 queries arriving over the decode
clock (V4); and a float32 smoke speculative pool on the card and the CPU.

Dense-cache generation path: the flash attention kernel (every
full-sequence attention: prefill, ``hidden``, ``logits``; bf16 on the
tensor cores, its SASS checked for HMMA) against its chunked plain version
and the dense reference (F1); the dense split-KV decode kernel against its
plain version and, bit for bit, against the paged decode kernel over the
same rows laid out as pages (D1); ``RestartEndpoint``
at h2o-danube-3-4b full width behind ``MultiLLMServer`` on the paged
endpoint's prompts, beside the paged endpoint (R1); and a float32 smoke pool
served by both endpoint kinds on the card and the CPU (R2).

The dual solve (3b): one thread-block cluster (16 CTAs where the card
places one, else 8) against its plain version on the route batch's
predictions in six cases and on a 131,072 x 16 problem whose rows do not
fit shared memory; its time at N 16,384, 4,096 and one row per CTA, and
its design bound.

The retrieval kernel (3xTF32 on the tensor cores; its SASS checked for
tensor-core instructions in both instances): the vote entry point against
its plain version on all 16,384 rows of the route batch and on the edge
cases (n_valid inside the store, k > n_valid, a duplicated store in exact
order, k = 64, a 700-row store, k = 65 refused) (3a); the top-k entry
point on the same cases and on a store duplicated at an offset of no tile
multiple, and at the full route batch, bit for bit equal to the vote entry
point's (vals, idx) (3c); both timed at the route batch and the stream
window beside their float32 and 3xTF32 bounds.  The assign-step kernel
against its plain version at the route batch's predictions with 3b's
multipliers, at N 1,000, M 16 and a duplicated column, two calls in a
row, three replays of one captured call, and its fast path against its
slow one; its device kernels a step (one launch: the last CTA adds the
block partials in order and resets its ticket counter), its time with the
wrapper, the wrapper's host time, its device time beside one launch's
floor and its bound (3d); the seed's per-iteration solve
(``benchmarks/bench_routing.py``: 151 assign-step launches a solve) on the
card with no host read, and captured once into a CUDA graph (151 launches
at the capture) and replayed, both equal to the same loop on the CPU,
beside the fused one-launch solve, and the legacy and sweep entry points
(``solve_assignment_kernel``, ``solve_assignment``, ``solve_budget``,
``DualSolver.solve_grid`` / ``solve_batch``) (3e).

Predictor training (phase T): ECCOS-T (150 steps of batch 64), ECCOS-H
(the same heads and the store) and the S3 baseline (``S3Cost.prepare``:
100 steps of batch 48) fit on the card on the Table 2 pool's training
split, in full float32 (TF32 off), every parameter and AdamW state on the
card; the same fits run on the CPU in phase S's worker processes, and
step 1's loss (within 1e-5 relative) and every ``eval_accuracy`` field
(within 0.02) are held card against CPU, beside the gradient gap, the
loss gaps and the card's ms a step.

The event-driven serving simulator (phase S): ``run_serving`` through
``OmniRouter`` over ECCOS-R on the card.  S1, the paper's Table 2 pool
(``generate(n=2700, seed=0).split()``, 271 test queries, loads 4):
batching (the fused dual solve), the streaming strawman over the first
108 queries, and batching with ``fold_online`` (the store grows by 271
rows mid-stream); then the other five policies of Table 2 in batching
mode (BA, S3, PO, and ECCOS-T and ECCOS-H behind ``OmniRouter`` on phase
T's fits), their SR and $ printed as the paper's Table 2.  S2,
``benchmarks/bench_robust.py``'s degraded pool at its full size (800
test queries, Poisson 80/s, windows of 0.25 s, budget 3.5 x the
surviving pool's floor): healthy, naive under the fault plan
(endpoint 0 hard down at t = 1, endpoint 1 erroring at 0.6 over
[0.5, 4)), and robust (breakers, the LCB solve at kappa 0.5; a warm-up
pass, then a timed one), held to the bench's acceptance.  Every window's
vote and blocked launches are held to their plain versions, and every
run is replayed on the CPU against the card's recorded predictions: the
replay's ``ServeResult`` must equal the card's in every field but the
wall time.  A plain CPU run with its own predictions is printed beside
it.  S3, a 16,384-query Poisson stream (~60 s of traffic, 64 arrivals a
window) over the 131,072-row store in budget mode (B = 2.5 x the true
floor), every 16th window's launches held: every query served within
1.05 B.  Each run prints its windows, dual iterations, route ms a window
(median and p90, by part), scheduling and LLM seconds and their ratio,
the makespan, the simulation's wall time and its launches.

The serving engine's failure plane (phase E).  E1: a float32 pool of the
h2o-danube-3-4b and gemma3-4b smoke configs behind ``MultiLLMServer`` on
the card and the CPU, once with hedging, endpoint 0 hard down over
chunks [6, 40), endpoint 1 erroring at 0.05, health, retries and the
stall watchdog, and once hedging against not hedging: card == CPU in the
completed requests, their order and outputs, the counters, trips and
breaker states; every allocator drains.  E2 (after the routed server):
h2o-danube-3-4b at full width and depth beside five smoke endpoints (one
per model of Table 2's pool) behind ``OmniRouter`` over phase T's ECCOS-H
with fold-back, health, hedging, the watchdog and one smoke endpoint hard
down mid-run: every request resolves once, the store grows by the folded
count, every allocator drains, and the vote, dual solve, paged decode and
flash kernels launch on the card.

The sanitizer plane and the runtime guards (phase G).  G1 (inside E2):
E2 again with every sanitizer member on (``repro_torch.analysis.
sanitize``): PageSan audits each endpoint between chunks and every
allocator passes ``assert_drained``; every count and token equals the
sanitizer-off run.  G2: phase S's S2 healthy stream and V4's routed spec
stream again with LedgerSan and SolveCert on: every window certified and
its ledger checked, the ``ServeResult`` (and the stream's outputs) equal
to the sanitizer-off card runs.  G3 (after E1): the schedule race
checker on the card, the engine explorer over E1's smoke pool and the
simulator explorer over a tie storm routed by ECCOS-R, three seeds each,
one end state.  G4 (after V2): ``no_host_sync`` fires on a deliberate
``.item()`` and not on ``device_get``; ``DualSolver.solve`` and
``route_arrays`` at the route batch's shape and one masked window at V2's
pass under it (a "warn" pass first lists any implicit sync's call site),
with their explicit reads printed and no compile event.

int8 KV pools (phase I1, inside the serving plane): h2o-danube-3-4b at
full width and depth with ``kv_cache_dtype="int8"``: paged int8 decode
against the dense int8 path and one verify round against decode at lens
+ s, in float32 and bf16 (unit-std scores, the full-width check's
limits); S4's endpoint with int8 pools beside bf16 pools (token
agreement, peak memory, ms a step, tokens/s: printed).

The recurrent families (phase H, after G3).  H1: hymba-1.5b at full
width and depth (32 layers, attention in parallel with SSD heads, head
dim 64, 5 query heads a kv head, window 1,024 but layers 10 and 21),
prompts of 700, 1,100, 1,537 and 2,000 prefilled alone into pages (each
prefill's ms printed: at 1,537 ``chunked_gla`` runs one position a
chunk) and 16 teacher-forced paged decode steps against the
full-sequence logits, with attention at unit-std scores and the
recurrent projections at unit fan-in (at full width the stock xLSTM's
float32 decode departs from its full sequence in the JAX package too,
tests/test_torch_recurrent.py::test_stock_xlstm_float32_decode_departs_in_jax):
in float32 held to ``FULL_LIMITS``, in bf16 held to that
float32 full sequence no worse than the bf16 full sequence is
(``TRUTH_FACTOR``; ``FULL_LIMITS`` reported), and each prompt's paged
decode alone to the dense ``decode_step`` from the same prefill, bit for
bit; one paged or dense decode launch per attention layer per step, one
flash launch per layer per prefill and logits call.  H3: hymba behind a
paged ``Endpoint`` at S4's shape (16 ragged prompts, 128 tokens; 0
re-prefills; tokens/s, a step's ms and an admission's prefill ms), then
the prompts cut to equal length served in float32 for 32 tokens by
``Endpoint`` and ``RestartEndpoint``: the same greedy tokens.  H2:
xlstm-350m (20 mLSTM, 4 sLSTM layers) as H1, with no attention launch.
H4: the reference's six-model serving pool at smoke size, float32,
behind ``OmniRouter(RetrievalPredictor(k=8))``, card against CPU per
request, and a recurrent endpoint refused as a speculative pair column.
F1 holds the flash kernel's head dim 64 at hymba's shapes.

The MoE family and the encoder-decoder (phases M and X, after H; each
model freed before the next is built, peak memory printed per
sub-phase).  M1: dbrx-132b at full width (d 6,144, 48/8 heads of 128, 16
experts top-4 of d_ff 10,752, vocabulary 100,352), depth cut from 40 to 2,
prompts of 1,000 and 1,537 prefilled alone, 16 teacher-forced steps
through ``decode_step_paged`` and, each prompt alone, through both it and
the dense ``decode_step``: float32 within ``FULL_LIMITS``, bf16 held to
the float32 full sequence by H1's rule, bf16 paged = dense bit for bit;
the share of (token, layer) whose top-4 expert set agrees between bf16
and float32 is printed.  M2: dbrx at depth 4 in bf16 behind a paged
``Endpoint`` (8 requests of 345-1,501 tokens, 64 new tokens each; 0
re-prefills, tokens/s, a step's ms, admission ms).  M3:
llama4-maverick-400b-a17b at full width, depth cut from 48 to one period
of its pattern (a dense layer, a MoE layer of 128 experts top-1 with a
shared expert), bf16: four prompts of 300-700, 8 paged steps within
``FULL_LIMITS`` of the full sequence, paged = dense per prompt bit for
bit, finite logits.  X1: seamless-m4t-large-v2
at full width and depth (24 encoder and 24 decoder layers): seeded frame
embeddings of 600 positions (the reference's stub frontend) and decoder
prompts of 300 tokens through ``prefill(tokens, embeds)`` and 16 dense
``decode_step``s against ``logits(tokens, embeds)``, in float32 and
bf16, with 72 flash launches a call (24 non-causal encoder, 24 causal,
24 cross-attention over the frames) and 48 dense decode launches a
step.  F1 adds the flash kernel at these heads (G 6 and 5 at D 128, the
non-causal encoder and the cross-attention at G 1, D 64), S2 the paged
decode at dbrx's and maverick's, D1 the dense decode at dbrx's (bf16 and
float32) and maverick's, at seamless's self-attention and over its whole
encoder cache.

Language-model training (phase L, after M and X): the flash backward
kernel (dq with Delta, then dk and dv; no atomics) against its plain
version at h2o-danube-3-4b's, hymba-1.5b's, dbrx-132b's and
seamless-m4t's heads, two launches bit-identical, timed beside its bound,
the plain version and SDPA's backward (L1); h2o-danube-3-4b at full width
and depth in bf16 through ``Trainer.train_step`` under the launcher's full
TrainConfig (8 microbatches, int8 moments, bf16 accumulation, remat full)
on 8 sequences of 4,096, after a float32 check of the kernels' loss and
gradients against the plain versions at 2 layers (L2); the launcher
``repro_torch.launch.train.main`` at smoke size, checkpointed and resumed
bit for bit (L3); one float32 train step per family on the card against
the CPU (L4).

The serving launcher and the analysis plane (phase N, after L).  N1:
``repro_torch.launch.serve.main`` on the card, batching 24 requests of 8
new tokens, with h2o-danube-3-4b, internlm2-20b, gemma3-4b, hymba-1.5b and
xlstm-350m at full width and depth in bf16 (``--full``; qwen2-72b's bf16
weights do not fit one card and it stays at smoke size) behind
``OmniRouter(RetrievalPredictor(k=8))``: every request served once, no
batch re-prefill, the vote, dual solve, paged decode and flash kernels
launched, each request's endpoint equal to the same launcher's route on
the CPU; then the same pool under Poisson arrivals with the streaming
dual.  N2: L2's profiled step and one decode chunk of N1's danube
endpoint read by ``repro_torch.analysis.profiler``: every hand kernel's
launches by name equal its ``ops`` counter times the device kernels one
launch makes; the busy share of each window, and
``analysis.analytic.memory_term``'s bytes and floor beside the measured
ms.  Every bound the script prints comes from
``repro_torch.analysis.kernel_work`` and ``roofline``.

Distribution (phase Q, after G4): four ranks started by
``repro_torch.launch.mesh.run_ranks`` share cuda:0 and talk over gloo,
every collective staged through host memory (NCCL refuses two ranks on one
card), so the phase proves the distributed semantics on the card and
measures no multi-card speed.  Q1: the query-sharded blocked solve of the
route batch's 16,384 ECCOS-H predictions (M 6, 16 shards, four a rank,
``norm_grad``, the stall exit on) in both modes, cold, over a three-window
warm stream and at a stall exit, held bit for bit (x, every SolveInfo and
DualState field) to the one-rank blocked solve (one launch of the cluster
ascent), each rank launching the shard-statistics kernel once an iteration
of its loop and gathering the stated bytes; its ms a solve time-sliced
beside the one launch's.  Q2: ``OmniRouter`` + ``StreamController`` over
windows of 37, 53, 30 and 4,096 queries, each rank predicting its rows
(the vote kernel on its shard): the assignments and the ledger (steps,
budget spent, deficit) equal the one-rank stream's bit for bit.  Q3:
``moe_ep`` at dbrx-132b's widths (d 6,144, d_ff 10,752, 16 experts, top-4,
bf16, 2,048 tokens) over (data 2 x model 2) and (4 x 1)
against ``moe_dense`` (capacity factor 8, within 2**-6 of the largest
output) and the one-rank ``_moe_local``'s dropped copies (capacity factor
1).  Q4: the compressed all-reduce (int8, bf16) of 16 Mi float32 over three
steps with error feedback against the plain mean, and a 4-stage pipeline
of 8 microbatches against the sequential product.  Q5: the FSDP x TP
train step of danube at full width (depth 2, float32) against the
one-rank step and its one-ulp floor.  Q6: the sequence-sharded decode.
Q7: the elastic re-mesh, a (2 x 2) state saved, restored under (1 x 4)
bit for bit, and stepped on.  Q8: the MoE family's sharded step,
dbrx-132b at full width (depth 1, capacity factor 8) on (2 x 2) under its
own train policy, on the bf16 flash kernels of every rank, against the
one-rank step run first in a process of its own.  C16 (in the serving
plane): an uncast float32 endpoint, card against CPU.

It checks the launch counters and the results, and prints one JSON line of
kernel figures, the card's name and power limit, and a last JSON line
``{"ok": true, "device": {...}}``.  It exits non-zero without a result when
no CUDA device is present or the package is missing.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_DB = 131_072          # vector store rows (top of BENCH_retrieval's grid)
N_ROUTE = 16_384        # route batch (top of BENCH_routing's grid)
N_WINDOW = 4_096        # streaming window
N_WINDOWS = 4
CMP_QUERIES = 1_024     # plain vote's (queries, N_db) block: 512 MiB
REPS = 20               # timed kernel launches (median)
# every bound comes from repro_torch.analysis: kernel_work counts a call's
# bytes and operations, roofline holds the H100's rates


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


def captured_call(torch, fn):
    """``fn()`` captured once into a CUDA graph on a side stream, after one
    call there (which makes the assign step's scratch for that stream).
    Returns (graph, what the captured call returned)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    from repro_torch.common import record_compile
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = fn()
    torch.cuda.current_stream().wait_stream(side)
    record_compile()        # a capture: a one-time compile event
    return graph, outs


def graph_ms(torch, fn) -> float:
    """The device's own time of one ``fn()``: GRAPH_CALLS calls captured in
    a CUDA graph (``captured_call``) and replayed, so the wrapper's host
    work is not on the clock."""
    def calls():
        for _ in range(GRAPH_CALLS):
            fn()

    graph, _ = captured_call(torch, calls)
    return time_ms(torch, graph.replay, 20) / GRAPH_CALLS


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
    # phase H: hymba-1.5b's heads (G 5 through the GMAX-8 instance) at H3's
    # batch in bf16 and at H1's prompts in float32
    ("hymba heads, window 1024", 16, 5, 5, 64, 16, 96, 1024, 1501,
     "bfloat16"),
    ("hymba heads, window 1024, float32", 4, 5, 5, 64, 16, 128, 1024, 2016,
     "float32"),
    # phase M: dbrx-132b's heads (G 6 through the GMAX-8 instance, D 128) at
    # M2's batch, lens up to its longest prompt grown by 64
    ("dbrx heads", 8, 8, 6, 128, 16, 98, 0, 1565, "bfloat16"),
    # llama4-maverick's heads (G 5, D 128) at M3's batch, lens up to its
    # longest prompt grown by its steps
    ("maverick heads", 4, 8, 5, 128, 16, 45, 0, 708, "bfloat16"),
]
CHECK_STEPS = 32        # teacher-forced decode steps of the full-width check
ENDPOINT_REQS = 16      # full-width endpoint: requests, prompt range, output
PROMPT_LO, PROMPT_HI, MAX_NEW = 256, 1536, 128
ROUTED_REQS = 48
CPU_REQS = 24
SMOKE_POOL = ("h2o-danube-3-4b", "internlm2-20b", "qwen2-72b", "gemma3-4b")

# -- the routed speculative stream (V phases) ---------------------------------
# V1: the paged verify kernel against its plain version and against the
# decode kernel at lens + s.  (tag, B, S, K, G, D, page size, pages per
# sequence, window, largest lens, dtype)
VERIFY_CASES = [
    ("danube heads", 16, 8, 8, 4, 120, 16, 128, 0, 1536 + 128, "bfloat16"),
    ("danube heads, window 4096", 16, 8, 8, 4, 120, 16, 288, 4096, 4600,
     "bfloat16"),
    ("gemma3-4b heads, window 1024", 16, 8, 4, 2, 256, 16, 128, 1024, 2048,
     "bfloat16"),
    ("small float32", 3, 8, 2, 4, 64, 16, 8, 24, 128, "float32"),
]
# V2: the masked solve, card vs CPU: (valid rows, padded rows) per window
STREAM_WINDOWS = ((3000, 4096), (5100, 8192), (4096, 4096), (6500, 8192))
STATS_CASES = ((4096, 1), (4096, 4), (16384, 1), (16384, 4))   # (N, lblocks)
# V3: a (2-layer draft, 24-layer verify) pair at full width
SPEC_K = 8
SPEC_REQS, SPEC_TOKENS = 8, 128
ID_TOKENS = 64          # tokens per request of the float32 identity run
ID_LIMIT = 0.99         # least share of speculative tokens = strong-only
GRAFT_EMIT = 0.9        # least mean tokens per round, as a share of k
# V4: the routed speculative stream
ROUTED_SPEC_QUERIES, ROUTED_SPEC_TOKENS = 32, 32
SPEC_CPU_REQS = 12
GRAPH_CALLS = 50        # calls per captured CUDA graph (graph_ms)
HOST_CALLS = 1_000      # calls enqueued back to back (host_us)

# -- the dense-cache generation path (F, D and R phases) ----------------------
# F1: the flash kernel against its plain versions.  (tag, B, S, Skv, K, G,
# D, window, q_offset, causal, dtype): S query rows at positions q_offset..
# over Skv keys (causal: Skv = q_offset + S).  FLASH_MAIN is the main
# path's shape (R1's rebuilds).
FLASH_CASES = [
    ("danube heads, window 4096", 1, 1000, 1000, 8, 4, 120, 4096, 0, True,
     "bfloat16"),
    ("restart rebuild, danube heads", 16, 1535, 1535, 8, 4, 120, 4096, 0,
     True, "bfloat16"),
    ("gemma3-4b heads, window 1024", 1, 2048, 2048, 4, 2, 256, 1024, 0, True,
     "bfloat16"),
    ("danube heads, float32", 1, 700, 700, 8, 4, 120, 0, 0, True, "float32"),
    ("danube heads, q_offset 448", 2, 300, 748, 8, 4, 120, 0, 448, True,
     "bfloat16"),
    ("hymba heads, window 1024", 1, 1537, 1537, 5, 5, 64, 1024, 0, True,
     "bfloat16"),
    ("hymba heads, B 16, window 1024", 16, 1500, 1500, 5, 5, 64, 1024, 0,
     True, "bfloat16"),
    ("hymba heads, window 1024, float32", 1, 1537, 1537, 5, 5, 64, 1024, 0,
     True, "float32"),
    # phase M: dbrx-132b's heads (G 6: 21 query positions a CTA, 126 of its
    # 128 rows live) at M1's longer prompt, llama4-maverick's (G 5) at M3's
    ("dbrx heads", 1, 1537, 1537, 8, 6, 128, 0, 0, True, "bfloat16"),
    ("maverick heads", 1, 700, 700, 8, 5, 128, 0, 0, True, "bfloat16"),
    # phase X: seamless-m4t-large-v2's encoder (non-causal, G 1, D 64) and
    # its cross-attention (300 decoder positions over 600 frames)
    ("seamless encoder, non-causal", 4, 600, 600, 16, 1, 64, 0, 0, False,
     "bfloat16"),
    ("seamless encoder, non-causal, float32", 4, 600, 600, 16, 1, 64, 0, 0,
     False, "float32"),
    ("seamless cross", 4, 300, 600, 16, 1, 64, 0, 0, False, "bfloat16"),
]
FLASH_MAIN = 1
FLASH_D64 = 6           # hymba-1.5b's head dim 64 (G 5) at H3's batch
# bf16: the least share of output elements within one bf16 ulp of the
# chunked version at the kernel's step is 1 - FLASH_ULP_SHARE.  The
# tensor cores accumulate Q.K^T in float32 with another rounding than IEEE
# float32 sums, so p = exp(s - m) rounds to another bf16 now and then and
# moves the rows whose terms cancel by more than one ulp (about 1e-4 of
# the elements on an H100); the bound against the reference stays 2e-2.
FLASH_ULP_SHARE = 1e-3
# D1: the dense decode kernel.  (tag, B, T, K, G, D, window, lens, dtype);
# lens an int shared by the batch, 0 for ragged lens including 1 and T, or
# (lo, hi) for ragged lens including both.
# DENSE_MAIN is R1's decode shape (T = 1,536 - 1 + 128, pos 1,535).
DENSE_CASES = [
    ("danube heads, restart decode", 16, 1663, 8, 4, 120, 4096, 1536,
     "bfloat16"),
    ("gemma3-4b heads, window 1024", 16, 2048, 4, 2, 256, 1024, 1800,
     "bfloat16"),
    ("small float32, ragged lens", 3, 700, 2, 4, 64, 0, 0, "float32"),
    # H3's restart decode: hymba-1.5b's heads, float32, prompts of about
    # 431 grown by up to RESTART_T_MAX positions
    ("hymba heads, restart decode, float32, ragged lens", 16, 559, 5, 5, 64,
     1024, 0, "float32"),
    # X1: seamless-m4t-large-v2's decoder self-attention (G 1, D 64) over
    # its grown cache, and its cross-attention over the whole 600-frame
    # encoder cache
    ("seamless self", 4, 316, 16, 1, 64, 0, (300, 315), "float32"),
    ("seamless cross", 4, 600, 16, 1, 64, 0, 600, "bfloat16"),
    # M1: dbrx-132b's heads (G 6, D 128) in both its types, lens over its
    # two prompts grown by M_CHECK_STEPS; M3: llama4-maverick's (G 5, D 128)
    # over its four prompts grown by M3_STEPS
    ("dbrx heads", 2, 1553, 8, 6, 128, 0, (1001, 1553), "bfloat16"),
    ("dbrx heads, float32", 2, 1553, 8, 6, 128, 0, (1001, 1553), "float32"),
    ("maverick heads", 4, 708, 8, 5, 128, 0, (301, 708), "bfloat16"),
]
DENSE_MAIN = 0
RESTART_T_MAX = 128     # R1: the restart endpoint's cache growth per rebuild
R2_POOL = ("h2o-danube-3-4b", "gemma3-4b")
R2_REQS, R2_LEN, R2_NEW = 9, 9, 6
# C16: a float32 configuration on its own bf16 init (uncast, as the
# reference runs it): bf16 activations against float32 pools, the decode
# entries promoting the queries before the paged kernel (row 6); card ==
# CPU, or at a request's first differing token the card's choice within
# C16_NEAR_TIE of the top of the CPU's own logits (a few bf16 ulps: the
# card's and the CPU's bf16 products round apart)
C16_ARCH, C16_REQS, C16_NEW, C16_NEAR_TIE = "h2o-danube-3-4b", 6, 8, 2.0 ** -5
# -- phase E: the serving engine's failure plane ------------------------------
# E1: the float32 smoke pool of the reference's engine fault tests (with
# gemma3-4b in hymba's place; phase H serves hymba), on the card and the
# CPU
E1_POOL = R2_POOL
E1_EP = dict(max_concurrency=2, t_max=32, page_size=8, sync_every=2)
E1_REQS, E1_NEW = 5, 8
E1_HEDGE_NEW = 12
# E2: full-width danube beside five smoke endpoints (Table 2's six models)
E2_SMOKE = ("internlm2-20b", "qwen2-72b", "gemma3-4b", "internlm2-20b",
            "qwen2-72b")
E2_REQS, E2_NEW = 48, 32
E2_DOWN = (3, 3.0)      # (endpoint, chunk) hard down from that chunk on
E2_HEDGE, E2_STALL = 2, 2   # chunks; a request takes E2_NEW / 8 = 4
# S4's prefill median per request when the chunked plain attention ran
# prefill on the card (NVIDIA H100 80GB HBM3, 700 W), printed beside the
# kernel's
PLAIN_PREFILL_MS = 355.5
# -- phase H: the recurrent families ------------------------------------------
# H1, H2: prompts that cross hymba's 1,024 window.  chunked_gla's chunk is
# gcd(s, 128) on a length that is not a multiple of 128, as the
# reference's: 1 at 1,537 (one position a chunk), 4 at 700 and 1,100, 16 at
# 2,000.  H_CHECK_STEPS teacher-forced steps (CHECK_STEPS cut to bound the
# chunk-1 prefills' time; the prompts stay)
H_PROMPTS = (700, 1100, 1537, 2000)
H_CHECK_STEPS = 16
# bf16 in the recurrent families: the chunked form (prefill, the full
# sequence) rounds the intra-chunk scores and the state update's operand to
# bf16 and the one-token step does not, so the two part by more than
# FULL_LIMITS["bf16"] in the JAX package too (tests/test_torch_recurrent.py
# ::test_bf16_xlstm_decode_departs_from_its_full_sequence_in_jax and
# ::test_bf16_hymba_decode_departs_from_its_full_sequence_in_jax, and
# ::test_bf16_decode_held_to_float32_as_chip_smoke_holds_it for the rule
# below at smoke size).  Both are held to the float32 full sequence of the
# same weights instead: the decode's max and rms differences from it no
# more than TRUTH_FACTOR times the bf16 full sequence's (FULL_LIMITS["bf16"]
# reported beside it).  Where bf16 departs from float32 by the order of the
# logits (xLSTM) that shows little, so each prompt's bf16 paged decode is
# also held to the dense decode_step, the same one-token form, from the
# same prefill: the same matmuls and attention kernels that agree bit for
# bit (D1), so bit for bit.  The batched paged decode, whose matmuls take
# another batch, is reported against them.  H_DENSE_STEPS of the
# H_CHECK_STEPS positions
H_DENSE_STEPS = 8
TRUTH_FACTOR = 2.0
# H3: S4's shape on hymba-1.5b: ENDPOINT_REQS requests, MAX_NEW tokens; the
# prompts cut to equal length served by Endpoint and RestartEndpoint in
# float32 for H_EQUAL_NEW tokens
H_PROMPT_LO, H_PROMPT_HI = 345, 1501
H_EQUAL_NEW = 32
# H4: the reference's serving pool (src/repro/launch/serve.py), smoke size
H4_POOL = ("h2o-danube-3-4b", "internlm2-20b", "qwen2-72b", "gemma3-4b",
           "hymba-1.5b", "xlstm-350m")
H4_REQS, H4_NEW = 24, 8


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


def logit_gaps(x, ref):
    """(max |x - ref| / max |ref|, rms (x - ref) / rms ref, argmax
    agreement)."""
    diff = x.float() - ref.float()
    return (float(diff.abs().max() / ref.abs().max()),
            float(diff.pow(2).mean().sqrt() / ref.float().pow(2).mean()
                  .sqrt()),
            float((x.argmax(-1) == ref.argmax(-1)).float().mean()))


def full_width_check(torch, np, model, params, dev, say, check, tag,
                     limits=None, plain=False, plens=(100, 237, 480, 511),
                     steps=CHECK_STEPS, truth=None, dense=False,
                     dense_steps=H_DENSE_STEPS):
    """Prefill ragged prompts (``plens``) alone into pages, teacher-force
    ``steps`` paged decode steps (one kernel launch per attention layer per
    step; with ``plain`` the plain version in the kernel's place), and hold
    each step's logits against the full-sequence logits at the same
    position (to ``limits``, (max relative difference, least argmax
    agreement), when given).  With ``truth`` (float32 full-sequence logits
    of the same weights at the same positions) both the decode and the
    full-sequence logits are measured against it, and the decode's max and
    rms differences must be within TRUTH_FACTOR times the full
    sequence's (argmax agreements reported: at 64 positions a few
    near-ties flip either way).  With ``dense`` each prompt's paged decode
    is also held to the dense ``decode_step`` from the same prefill, bit for
    bit, over the first ``dense_steps`` positions (``dense_against_paged``).
    Returns the relative difference, the argmax agreement, each prompt's
    prefill ms, the ms of a decode step, the flash, paged and dense decode
    launches, the full-sequence logits at the decode positions and, with
    ``dense``, each prompt's decode alone (``alone``)."""
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.zoo import prefill_into_pages
    cfg = model.cfg
    # layers with attention: every layer of the dense family and of hymba,
    # none of xLSTM's
    n_attn = sum(count * sum(k.block in ("attn", "hymba") for k in pattern)
                 for count, pattern in model.plan)
    fa_ops.launches = 0
    rng = np.random.RandomState(0)
    plens = list(plens)
    ps, nb = 16, len(plens)
    p_max = -(-(max(plens) + steps) // ps)
    seqs = [rng.randint(1, cfg.vocab_size, (n + steps,)) for n in plens]
    state = model.empty_paged_state(nb, 1 + nb * p_max, ps, device=dev)
    bt = torch.arange(1, 1 + nb * p_max, dtype=torch.int32,
                      device=dev).reshape(nb, p_max)
    pre_ms, caches = [], []
    for i, n in enumerate(plens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, _ = model.prefill(params, torch.as_tensor(seqs[i][None, :n],
                                                         device=dev))
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
        prefill_into_pages(state, cache, bt[i, :-(-n // ps)].long(), i, ps)
        if dense:
            caches.append(cache)
        del cache
    lens = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    dec = []
    kernel_fn = pd_ops.paged_decode_attention
    if plain:
        pd_ops.paged_decode_attention = paged_decode_attention_ref
    pd_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for t in range(steps):
            tok = torch.as_tensor(np.array([[s[n + t]] for s, n in
                                            zip(seqs, plens)]),
                                  dtype=torch.int32, device=dev)
            _, lg = model.decode_step_paged(params, state, tok, bt, lens)
            dec.append(lg[:, :cfg.vocab_size])
            lens = lens + 1
        torch.cuda.synchronize()
    finally:
        pd_ops.paged_decode_attention = kernel_fn
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    paged = pd_ops.launches
    full = [model.logits(params, torch.as_tensor(s[None], device=dev))[
        0, :, :cfg.vocab_size] for s in seqs]
    torch.cuda.synchronize()
    check(paged == (0 if plain else n_attn * steps),
          f"{cfg.name} full-width check ({tag}): one kernel launch per "
          "attention layer per step")
    # every full-sequence attention (the prefills and the logits) went
    # through the flash kernel
    check(fa_ops.launches == n_attn * 2 * nb,
          f"{cfg.name} full-width check ({tag}): one flash launch per "
          "attention layer per prefill and per full-sequence logits call")
    dec = torch.stack(dec, dim=1)                        # (B, steps, V)
    ref = torch.stack([f[n:n + steps] for f, n in zip(full, plens)])
    check(bool(torch.isfinite(dec).all() and torch.isfinite(ref).all()),
          f"{cfg.name} full-width check ({tag}): non-finite logits")
    rel = float((dec - ref).abs().max() / ref.abs().max())
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    say(f"{cfg.name} full width {tag}, {nb} sequences (prompts {plens}) x "
        f"{steps} teacher-forced paged decode steps "
        f"({'plain version' if plain else 'kernel'}) vs full-sequence "
        f"logits: max|diff|/max|logit| = {rel:.4g}, argmax agreement "
        f"{agree:.4f}" + (f" (limits: <= {limits[0]}, >= {limits[1]})"
                          if limits else " (reported)")
        + f" | prefill ms " + ", ".join(
            f"{n}: {t:.1f}" for n, t in zip(plens, pre_ms))
        + f" | decode step {step_ms:.2f} ms (B={nb}) | launches: flash "
        f"{fa_ops.launches}, paged decode {paged}")
    if limits:
        check(rel <= limits[0] and agree >= limits[1],
              f"{cfg.name} full-width check ({tag}): decode disagrees with "
              "the full sequence")
    out = dict(rel=rel, agree=agree, prefill_ms=dict(zip(plens, pre_ms)),
               step_ms=step_ms, flash=fa_ops.launches, paged=paged, dense=0,
               ref=ref)
    if dense:
        got = dense_against_paged(torch, model, params, caches, seqs,
                                  plens, dec, n_attn, say, check, tag,
                                  dense_steps)
        out["paged"] += got["paged"]
        out["dense"] = got["dense"]
        out["alone"] = got["alone"]
        del caches
    if truth is not None:
        out["decode_vs_f32"] = logit_gaps(dec, truth)
        out["full_vs_f32"] = logit_gaps(ref, truth)
        d, f = out["decode_vs_f32"], out["full_vs_f32"]
        say(f"  {cfg.name} {tag} against the float32 full sequence (max, "
            f"rms relative; argmax agreement): decode {d[0]:.4g}, "
            f"{d[1]:.4g}; {d[2]:.4f}, full sequence {f[0]:.4g}, {f[1]:.4g}; "
            f"{f[2]:.4f} (the decode's two within {TRUTH_FACTOR} x the full "
            f"sequence's)")
        check(d[0] <= TRUTH_FACTOR * f[0] and d[1] <= TRUTH_FACTOR * f[1],
              f"{cfg.name} full-width check ({tag}): decode farther from the "
              "float32 logits than the full sequence")
    return out


def dense_against_paged(torch, model, params, caches, seqs, plens, dec,
                        n_attn, say, check, tag, steps=H_DENSE_STEPS):
    """Each prompt alone from its prefill cache: the first ``steps``
    teacher-forced positions of the batched paged decode ``dec`` (B, steps,
    V) decoded again by paged decode steps (a one-slot paged state) and by
    dense ``decode_step``s.  The two take the same matmuls and attention
    kernels that agree bit for bit (D1), so they must agree bit for bit.
    ``dec`` is measured against them too (reported: the matmuls' batch
    differs, which moves bf16 logits by their rounding).  Returns the
    paged and dense decode launches and the logits of both (``alone``)."""
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.models.zoo import pad_cache, prefill_into_pages
    cfg = model.cfg
    dev = dec.device
    steps, ps = min(steps, dec.shape[1]), 16
    dec = dec[:, :steps]
    pd_ops.launches = pd_ops.dense_launches = 0
    alone = {"paged": torch.empty_like(dec), "dense": torch.empty_like(dec)}
    for i, (cache, n) in enumerate(zip(caches, plens)):
        n_pg = -(-(n + steps) // ps)
        state = model.empty_paged_state(1, 1 + n_pg, ps, device=dev)
        bt = torch.arange(1, 1 + n_pg, dtype=torch.int32,
                          device=dev)[None]
        prefill_into_pages(state, cache, bt[0, :-(-n // ps)].long(), 0, ps)
        dense = pad_cache(cache, n + steps)
        lens = torch.full((1,), n, dtype=torch.int32, device=dev)
        for t in range(steps):
            tok = torch.as_tensor([[seqs[i][n + t]]], dtype=torch.int32,
                                  device=dev)
            _, lg = model.decode_step_paged(params, state, tok, bt, lens)
            alone["paged"][i, t] = lg[0, :cfg.vocab_size]
            dense, lg = model.decode_step(params, dense, tok)
            alone["dense"][i, t] = lg[0, :cfg.vocab_size]
            lens = lens + 1
        del state, dense
    torch.cuda.synchronize()
    got = dict(paged=pd_ops.launches, dense=pd_ops.dense_launches)
    same = bool(torch.equal(alone["paged"], alone["dense"]))
    diff = float((alone["paged"] - alone["dense"]).abs().max())
    batch = (float((alone["dense"] - dec).abs().max() / dec.abs().max()),
             float((alone["dense"].argmax(-1) == dec.argmax(-1)).float()
                   .mean()))
    say(f"  {cfg.name} {tag}: each prompt alone, paged decode against the "
        f"dense decode_step: max|diff| = {diff:.4g} (expected 0); the "
        f"batched paged decode against them (reported): {batch[0]:.4g} "
        f"relative, argmax agreement {batch[1]:.4f}; launches {got}")
    check(got["paged"] == got["dense"] == n_attn * steps * len(plens),
          f"{cfg.name} ({tag}): paged or dense decode launches != one per "
          "attention layer per step per prompt")
    check(same, f"{cfg.name} ({tag}): the dense decode differs from the "
          "paged decode of the same prompt")
    got["alone"] = alone
    return got


# the leaves whose "scaled" init takes its fan-in from shape[-2] (the head
# count; 2 for w_gates) and not from the width it contracts (d_model or
# the mLSTM's d_inner), by the key of the block that holds them: every
# attention's wq and wk (a dense or hymba layer's ``attn``) and the
# recurrent blocks' 3-D projections
FAN_IN_LEAVES = {"attn": ("wq", "wk"), "cross": ("wq", "wk"),
                 "ssd": ("w_x", "w_z", "w_b", "w_c"),
                 "mlstm": ("wq", "wk", "wv", "w_gates"), "slstm": ("w_in",)}


def _unit_fan_in(tree):
    """The tree with the FAN_IN_LEAVES rescaled from the init's fan-in to
    the contracted width (shape[1] of the stacked (count, width, ...)
    leaf): q and k of unit std, so attention scores of unit std, and the
    SSD heads' x, z, B and C, the mLSTM's q, k, v and gates and the
    sLSTM's gate pre-activations of unit std, not 6-32 times that.  New
    tensors for those leaves; every other leaf is shared."""
    import math

    def walk(node, key=None):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, k) for k, v in node.items()}
        for name in FAN_IN_LEAVES.get(key, ()):
            w = node[name]
            out[name] = w * math.sqrt(w.shape[-2] / w.shape[1])
        return out

    return walk(tree)


def serving_plane(torch, np, dev, say, check, time_ms, heads):
    """The serving-plane phases and E2 (``heads``: phase T's fitted
    ECCOS-H encoder); returns the kernels-line row of the paged decode
    kernel and the other kernels' launches."""
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
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import (Endpoint, MultiLLMServer, Request,
                                            null_route_features)
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.analysis import kernel_work

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
    full_width_check(torch, np, model32, _unit_fan_in(params32), dev, say,
                     check, "float32, unit-std scores",
                     limits=FULL_LIMITS["float32"])
    del params32
    full_width_check(torch, np, model, _unit_fan_in(params), dev, say, check,
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
    fa_ops.launches = 0
    pre_ms, flash_ev = [], []
    flash_inner = fa_ops.flash_attention

    def timed_flash(*a, **kw):
        # CUDA events around each launch: the flash share of a prefill
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = flash_inner(*a, **kw)
        ev[1].record()
        flash_ev.append(ev)
        return out

    fa_ops.flash_attention = timed_flash
    try:
        for r in reqs:
            t0 = time.perf_counter()
            ep.admit(r)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        fa_ops.flash_attention = flash_inner
    s4_flash = fa_ops.launches
    flash_req_ms = sum(a.elapsed_time(b) for a, b in flash_ev) / len(reqs)
    check(s4_flash == cfg.n_layers * ENDPOINT_REQS,
          "endpoint: the admission prefills did not launch the flash kernel "
          "once per layer")
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
        f"(median; {min(pre_ms):.1f}..{max(pre_ms):.1f}; flash kernel, "
        f"{s4_flash} launches, {flash_req_ms:.2f} ms a request on the "
        f"device = {flash_req_ms / float(np.mean(pre_ms)):.1%} of the mean "
        f"prefill; with the chunked plain attention: "
        f"{PLAIN_PREFILL_MS} ms) | decode chunk "
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
    k_dev = graph_ms(torch, lambda: paged_decode_attention_cuda(
        q_e, k_pool, v_pool, bt_e, lens_e, window=window))
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
    nbytes, nops = kernel_work.decode_attention(
        lens_e.cpu(), q_e.shape[2], cfg.n_kv_heads, cfg.hd, window, 2,
        bt_e.numel())
    bound, bound_by = kernel_work.attention_bound(nbytes, nops, 2)
    share = k_ms * cfg.n_layers / (chunk_med / ep.sync_every)
    say(f"paged decode kernel at the endpoint's lens (B={ENDPOINT_REQS}, "
        f"lens {int(lens_e.min())}..{int(lens_e.max())}, P="
        f"{bt_e.shape[1]}): {k_ms * 1e3:.1f} us/launch with the wrapper, "
        f"{k_dev * 1e3:.1f} us on the device (CUDA graph), bound "
        f"{bound * 1e3:.1f} us = max({nbytes / 1e6:.2f} MB / 3.35 TB/s, "
        f"{nops / 1e9:.3f} GFLOP, Q.K half at 989 TFLOP/s bf16, P.V half at"
        f" 67 TFLOP/s fp32) -> {bound / k_ms:.1%} "
        f"of it; plain {p_ms * 1e3:.1f} us; SDPA over the pre-gathered dense"
        f" K/V (all {bt_e.shape[1] * 16} positions, gather excluded) "
        + (f"{lib_ms * 1e3:.1f} us" if lib_ms is not None else "n/a")
        + f"; {cfg.n_layers} launches = {share:.1%} of a decode step")
    row = dict(name="paged_decode_attention", route="cuda",
               source="src/repro_torch/csrc/paged_decode.cu",
               replaces="src/repro/kernels/decode_attention/kernel.py:197",
               max_abs_err=pd_err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
               bound_by=bound_by, library_ms=lib_ms, graph_ms=k_dev)
    del ep, k_pool, v_pool

    # R1. the restart baseline at full width on S4's prompts, beside the
    # paged endpoint behind the same server
    r1 = restart_phase(torch, np, dev, say, check, cfg, params,
                       [r.tokens for r in reqs])

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
    del eps, srv
    e2, g1 = failure_plane_full_width(torch, np, dev, say, check, cfg,
                                      params, heads)
    # I1. int8 KV pools at full width, against the dense int8 path and
    # beside bf16 pools
    i1 = int8_phase(torch, np, dev, say, check, cfg, params,
                    [r.tokens for r in reqs])
    del params

    # S6. the all-smoke float32 pool behind BalanceAware, card vs CPU
    cfgs = [dataclasses.replace(get_smoke_config(a), dtype=torch.float32)
            for a in SMOKE_POOL]
    host = [_f32(build_model(c).init(i, "cpu")) for i, c in enumerate(cfgs)]
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
    row["launches"] = (ep_launches + routed_launches + e2["paged"]
                       + g1["paged"] + i1["paged"])
    say(f"paged decode launches on the main path: endpoint {ep_launches}, "
        f"routed server {routed_launches}, E2 {e2['paged']}, G1 "
        f"{g1['paged']}, I1 {i1['paged']} (its bf16-pool endpoint)")

    # R2. the float32 smoke pool, paged vs restart, card vs CPU
    restart_smoke_pool(torch, np, dev, say, check)
    # C16. an uncast float32 endpoint, card vs CPU
    row["launches"] += uncast_endpoint_check(torch, np, dev, say, check)
    return row, {"flash": s4_flash + r1["flash"] + e2["flash"]
                 + g1["flash"] + i1["flash"],
                 "dense": r1["dense"] + i1["dense"],
                 "i1": i1,
                 "vote": e2["vote"] + g1["vote"],
                 "dual_solve": e2["dual_solve"] + g1["dual_solve"]}


def e2_run(torch, np, dev, cfg, params, heads):
    """One E2 run (see :func:`failure_plane_full_width`) from fresh
    endpoints and a fresh store.  Returns its server, endpoints, completed
    requests, launches, store sizes before and after, and wall seconds."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (HybridPredictor, OmniRouter,
                                  PredictorConfig, RouterConfig)
    from repro_torch.data.qaserve import generate
    from repro_torch.data.tokenizer import encode_for_config
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    from repro_torch.serving.engine import Endpoint, MultiLLMServer, Request
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    train, _, test = generate(n=S1_N, seed=0).split()
    ds = test.subset(np.arange(E2_REQS))
    smoke = [get_smoke_config(a) for a in E2_SMOKE]
    eps = [Endpoint(cfg, max_concurrency=4, t_max=128, page_size=16,
                    sync_every=8, params=params, device=dev)]
    eps += [Endpoint(c, max_concurrency=4, t_max=128, page_size=16,
                     sync_every=8, seed=i + 1, device=dev)
            for i, c in enumerate(smoke)]
    hp = HybridPredictor(PredictorConfig(n_models=train.m, n_buckets=10),
                         params=heads, device=dev).fit_store(train)
    size0 = hp.retrieval.vstore.size
    down, at = E2_DOWN
    srv = MultiLLMServer(
        eps, OmniRouter(hp, RouterConfig(alpha=S1_ALPHA)), fold_online=True,
        health=True, hedge_after_steps=E2_HEDGE,
        stall_after_chunks=E2_STALL,
        fault_plan=FaultPlan({down: (FaultSpec("hard_down", start=at),)},
                             seed=0))
    small_vocab = min([cfg] + smoke, key=lambda c: c.vocab_size)
    for rid, text in enumerate(ds.queries):
        srv.submit(Request(rid, encode_for_config(small_vocab, text),
                           max_new=E2_NEW))
    tr_ops.launches = la_ops.launches = pd_ops.launches = 0
    fa_ops.launches = 0
    t0 = time.perf_counter()
    done = srv.run(lambda b: ds.subset(np.array([r.rid for r in b])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = dict(vote=tr_ops.launches, dual_solve=la_ops.launches,
             paged=pd_ops.launches, flash=fa_ops.launches)
    return dict(srv=srv, eps=eps, done=done, launches=n, size0=size0,
                size1=hp.retrieval.vstore.size, wall=wall, hp=hp,
                smoke=smoke)


def e2_summary(res):
    """Everything an E2 run counted, and every request's outcome."""
    srv = res["srv"]
    return dict(
        trace=sorted((r.rid, r.endpoint, r.failed, tuple(r.output))
                     for r in res["done"]),
        counters=(srv.failures, srv.retries, srv.hedged, srv.folded,
                  srv.windows),
        health=(srv.health.trips, srv.health.breaker_state.tolist()),
        store=(res["size0"], res["size1"]), launches=res["launches"])


def failure_plane_full_width(torch, np, dev, say, check, cfg, params,
                             heads):
    """E2, engine-faults-danube: h2o-danube-3-4b at full width and depth
    (bf16) beside five smoke endpoints, one per model of Table 2's pool,
    behind ``OmniRouter`` over phase T's fitted ECCOS-H heads and the
    Table 2 store, serving the first 48 test queries with online
    fold-back, health, hedging, the stall watchdog and smoke endpoint 3
    hard down from chunk 3.  Every request resolves exactly once, the
    store grows by the folded count, every allocator drains, and the
    vote, dual solve, paged decode and flash kernels launch on the card.

    G1: the same run again with every sanitizer member on: PageSan audits
    each endpoint between chunks (``Endpoint._san_check``) and
    ``assert_drained`` holds on every endpoint at the end; its counts,
    launches and every request's tokens equal the sanitizer-off run's.
    Returns E2's launches and G1's."""
    from repro_torch.analysis import sanitize
    res = e2_run(torch, np, dev, cfg, params, heads)
    srv, eps, done, n = res["srv"], res["eps"], res["done"], res["launches"]
    smoke, size0, size1 = res["smoke"], res["size0"], res["size1"]
    down, at = E2_DOWN
    rids = [r.rid for r in done]
    per_ep = np.bincount([r.endpoint for r in done if not r.failed],
                         minlength=len(eps))
    say(f"E2 engine-faults-danube (danube full width + "
        f"{', '.join(c.name for c in smoke)}; OmniRouter over phase T's "
        f"ECCOS-H, endpoint {down} hard down from chunk {at:g}): "
        f"{len(done)}/{E2_REQS} resolved ({sum(r.failed for r in done)} "
        f"failed), per endpoint {per_ep.tolist()}, failures "
        f"{srv.failures}, retries {srv.retries}, hedged {srv.hedged}, trips "
        f"{srv.health.trips}, breakers {srv.health.breaker_state.tolist()},"
        f" folded {srv.folded} (store {size0} -> {size1}), {srv.windows} "
        f"windows, wall {res['wall']:.2f} s, launches {n}")
    check(sorted(rids) == list(range(E2_REQS)),
          "E2: a request was lost or resolved twice")
    check(all(r.failed or (r.done and len(r.output) == E2_NEW)
              for r in done), "E2: a served request is short")
    check(srv.folded > 0 and size1 == size0 + srv.folded,
          "E2: the store did not grow by the folded count")
    check(all(_drained(e) for e in eps) and not srv._hedges
          and not srv._shadow_ids, "E2: an allocator did not drain")
    check(srv.retries > 0 and srv.hedged > 0 and srv.health.trips >= 1
          and srv.health.breaker_state[down] != 0,
          "E2: no retry or hedge, or the dead endpoint's breaker is closed")
    check(all(e.device.type == "cuda" for e in eps)
          and res["hp"].device.type == "cuda", "E2: a part ran off the card")
    check(all(v > 0 for v in n.values()), f"E2: a kernel was not launched "
          f"({n})")
    off = e2_summary(res)
    del res, srv, eps, done

    # G1. the same run with every member on
    audits = [0]
    check_endpoint = sanitize.PageSan.check_endpoint

    def counted(self, ep=None):
        audits[0] += 1
        return check_endpoint(self, ep)

    sanitize.PageSan.check_endpoint = counted
    try:
        with sanitize.enabled():
            ev0 = dict(sanitize.counters)
            res = e2_run(torch, np, dev, cfg, params, heads)
            for ep in res["eps"]:
                check(ep.alloc.san is not None,
                      "G1: an endpoint has no PageSan attached")
                ep.alloc.san.assert_drained(ep)
            moved = {k: sanitize.counters[k] - ev0[k] for k in ev0}
    finally:
        sanitize.PageSan.check_endpoint = check_endpoint
    on = e2_summary(res)
    same = {k: on[k] == off[k] for k in off}
    say(f"G1 PageSan on E2 (all three members on): counters moved {moved}, "
        f"{audits[0]} endpoint audits, assert_drained on all "
        f"{len(res['eps'])} endpoints; wall {res['wall']:.2f} s (off: see "
        f"E2); equal to the sanitizer-off run: {same}")
    check(moved["events"] > 0 and audits[0] > 0,
          "G1: PageSan saw no event")
    check(all(same.values()), f"G1: the sanitized E2 run differs: {same}")
    return n, res["launches"]


def restart_phase(torch, np, dev, say, check, cfg, params, prompts):
    """R1, restart-danube-16x128: ``RestartEndpoint`` at full width behind
    ``MultiLLMServer(BalanceAware)`` on S4's prompts, after the paged
    ``Endpoint`` on the same prompts behind the same server.  Every admit
    and the completion re-prefill the whole left-padded batch through the
    flash kernel; decode runs the dense decode kernel.  Counts are set to 0
    just before each run and read just after.  Returns the restart run's
    and the paged run's flash launches and the dense decode launches."""
    from repro_torch.core import BalanceAware
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serving.engine import (Endpoint, MultiLLMServer, Request,
                                            RestartEndpoint,
                                            null_route_features)
    n = len(prompts)
    # the server's capacity rule lets half the pool's slots be in flight:
    # 2n slots let all n requests decode together, as in S4
    slots = 2 * n
    res = {}
    for name in ("paged", "restart"):
        rebuild_s = []
        if name == "paged":
            ep = Endpoint(cfg, max_concurrency=slots, t_max=2048,
                          page_size=16, sync_every=8, params=params,
                          device=dev)
        else:
            ep = RestartEndpoint(cfg, max_concurrency=slots,
                                 t_max=RESTART_T_MAX, params=params,
                                 device=dev)
            inner = ep._rebuild

            def timed_rebuild(inner=inner):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inner()
                torch.cuda.synchronize()
                rebuild_s.append(time.perf_counter() - t0)

            ep._rebuild = timed_rebuild
        srv = MultiLLMServer([ep], BalanceAware())
        for i, p in enumerate(prompts):
            srv.submit(Request(i, p, max_new=MAX_NEW))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa_ops.launches = pd_ops.launches = pd_ops.dense_launches = 0
        t0 = time.perf_counter()
        served = srv.run(null_route_features)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res[name] = dict(
            wall=wall, served=served, rebuild_s=rebuild_s,
            reprefills=ep.batch_reprefills, prefills=ep.prefill_calls,
            steps=ep.busy_steps * getattr(ep, "sync_every", 1),
            flash=fa_ops.launches, paged=pd_ops.launches,
            dense=pd_ops.dense_launches,
            peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        check(len(served) == n and all(
            r.done and len(r.output) == MAX_NEW for r in served),
              f"R1 {name}: not every request got {MAX_NEW} tokens")
        if name == "restart":
            del ep._rebuild
        del srv, ep
    pg, rs = res["paged"], res["restart"]
    lay = cfg.n_layers
    check(pg["reprefills"] == 0, "R1 paged: batch re-prefill")
    check(rs["reprefills"] > 0, "R1 restart: no batch re-prefill")
    check(pg["flash"] == lay * pg["prefills"] and pg["dense"] == 0
          and pg["paged"] == lay * pg["steps"],
          "R1 paged: launches != one per layer per prefill and per step")
    check(rs["flash"] == lay * rs["prefills"] and rs["paged"] == 0
          and rs["dense"] == lay * rs["steps"],
          "R1 restart: launches != one per layer per rebuild and per step")
    toks = n * MAX_NEW
    reb = rs["rebuild_s"]
    step_ms = (rs["wall"] - sum(reb)) / rs["steps"] * 1e3
    say(f"R1 restart-danube-16x128 (danube full width, bf16, {slots} slots"
        f" ({n} in flight), restart t_max {RESTART_T_MAX}, BalanceAware; prompts "
        f"{min(map(len, prompts))}..{max(map(len, prompts))}, {MAX_NEW} "
        f"tokens): restart {len(rs['served'])}/{n} served in "
        f"{rs['wall']:.2f} s = {toks / rs['wall']:.1f} tokens/s vs paged "
        f"{len(pg['served'])}/{n} in {pg['wall']:.2f} s = "
        f"{toks / pg['wall']:.1f} tokens/s (paged {rs['wall'] / pg['wall']:.3f}"
        f"x restart)"
        f" | restart: {rs['reprefills']} rebuilds ({rs['prefills']}"
        f" prefill calls) taking {sum(reb):.2f} s, "
        f"{np.median(reb):.3f} s median, {max(reb):.3f} s longest; decode "
        f"{rs['steps']} steps at {step_ms:.1f} ms/step (wall less "
        f"rebuilds); peak {rs['peak']:.2f} GiB vs paged {pg['peak']:.2f} GiB"
        f" | launches: restart flash {rs['flash']}, dense decode "
        f"{rs['dense']}; paged flash {pg['flash']}, paged decode "
        f"{pg['paged']}; batch re-prefills paged {pg['reprefills']}")
    return {"flash": pg["flash"] + rs["flash"], "dense": rs["dense"]}


def restart_smoke_pool(torch, np, dev, say, check):
    """R2: a float32 pool of two smoke configs behind ``BalanceAware``,
    served by ``Endpoint`` and by ``RestartEndpoint`` with equal prompt
    lengths (so the restart batch's left pads are inert), on the card and on
    the CPU: paged == restart (the reference's contract) and card == CPU."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import BalanceAware
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import (Endpoint, MultiLLMServer, Request,
                                            RestartEndpoint,
                                            null_route_features)
    cfgs = [dataclasses.replace(get_smoke_config(a), dtype=torch.float32)
            for a in R2_POOL]
    host = [_f32(build_model(c).init(i, "cpu")) for i, c in enumerate(cfgs)]
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 500, (R2_LEN,)).astype(np.int32)
               for _ in range(R2_REQS)]
    outs, reprefills, card_launches = {}, {}, {}
    for where_tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        for name, cls in (("paged", Endpoint), ("restart", RestartEndpoint)):
            eps = [cls(c, max_concurrency=3, device=where,
                       params=_tree_to(host[i], where))
                   for i, c in enumerate(cfgs)]
            srv = MultiLLMServer(eps, BalanceAware(), batch_size=6)
            for i, p in enumerate(prompts):
                srv.submit(Request(i, p, max_new=R2_NEW))
            fa_ops.launches = pd_ops.dense_launches = 0
            done = srv.run(null_route_features)
            key = (where_tag, name)
            card_launches[key] = (fa_ops.launches, pd_ops.dense_launches)
            outs[key] = {r.rid: (r.endpoint, tuple(r.output)) for r in done}
            reprefills[key] = sum(e.batch_reprefills for e in eps)
            check(len(done) == R2_REQS and all(
                len(r.output) == R2_NEW for r in done),
                  f"R2 {key}: a request was lost")
    same = {w: outs[(w, "paged")] == outs[(w, "restart")]
            for w in ("card", "cpu")}
    card_cpu = {n: outs[("card", n)] == outs[("cpu", n)]
                for n in ("paged", "restart")}
    say(f"R2 smoke pool float32 ({', '.join(R2_POOL)} smoke; {R2_REQS} "
        f"requests, prompts of {R2_LEN}, {R2_NEW} tokens): paged == restart "
        f"on the card {same['card']}, on the CPU {same['cpu']}; card == CPU "
        f"paged {card_cpu['paged']}, restart {card_cpu['restart']}; batch "
        f"re-prefills {reprefills}; card launches (flash, dense decode) "
        f"{card_launches[('card', 'paged')]} paged, "
        f"{card_launches[('card', 'restart')]} restart")
    check(same["card"] and same["cpu"], "R2: paged != restart")
    check(card_cpu["paged"] and card_cpu["restart"], "R2: card != CPU")
    check(reprefills[("card", "paged")] == 0
          and reprefills[("card", "restart")] > 0, "R2: re-prefill counts")
    check(card_launches[("card", "restart")][0] > 0
          and card_launches[("card", "restart")][1] > 0
          and card_launches[("cpu", "restart")] == (0, 0),
          "R2: the card did not run the kernels, or the CPU launched them")


def uncast_endpoint_check(torch, np, dev, say, check):
    """C16: the danube smoke endpoint in the float32 configuration on its
    own bf16 init (no cast), on the card and on the CPU: float32 pools
    under bf16 queries, which ``decode_attention.ops`` promotes before the
    paged kernel.  The card's greedy tokens equal the CPU's, or differ
    first at a near tie of the CPU's own logits.  Returns the card's paged
    decode launches."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Endpoint, Request
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_smoke_config(C16_ARCH), dtype=torch.float32)
    model = build_model(cfg)
    host = model.init(16, "cpu")
    rng = np.random.RandomState(16)
    prompts = [rng.randint(1, cfg.vocab_size, (int(rng.randint(5, 40)),))
               .astype(np.int32) for _ in range(C16_REQS)]
    outs, launches, pools = {}, {}, set()
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        ep = Endpoint(cfg, max_concurrency=3, t_max=64, page_size=8,
                      device=where, params=_tree_to(host, where))
        pools |= {t.dtype for t in _leaves(ep._state)
                  if isinstance(t, torch.Tensor) and t.is_floating_point()}
        reqs = [Request(i, p, max_new=C16_NEW) for i, p in enumerate(prompts)]
        pd_ops.launches = 0
        nxt = 0
        while nxt < len(reqs) or ep.active_count():
            while nxt < len(reqs) and ep.has_capacity():
                ep.admit(reqs[nxt])
                nxt += 1
            ep.step()
        launches[tag] = pd_ops.launches
        outs[tag] = [list(r.output) for r in reqs]
    equal, worst = 0, 0.0
    for prompt, a, b in zip(prompts, outs["card"], outs["cpu"]):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        check(len(a) == len(b) == C16_NEW, "C16: a request was not served")
        if not diff:
            equal += 1
            continue
        i = diff[0]
        seq = torch.from_numpy(np.concatenate(
            [prompt, np.asarray(b[:i], np.int32)])[None])
        with torch.no_grad():
            _, logits = model.prefill(host, seq)
        logits = logits[0].float()
        gap = float(logits.max() - logits[a[i]])
        rel = gap / float(logits.abs().max())
        worst = max(worst, rel)
        check(rel <= C16_NEAR_TIE, f"C16: the card's token {a[i]} at step "
              f"{i} lies {rel:.3g} below the top of the CPU's logits")
    check(pools == {torch.float32}, f"C16: pools {pools}")
    check(launches["card"] > 0 and launches["cpu"] == 0,
          f"C16: paged decode launches {launches}")
    took = time.perf_counter() - t0
    say(f"C16 uncast float32 endpoint ({C16_ARCH} smoke on its bf16 init, "
        f"float32 pools; {C16_REQS} requests of {C16_NEW} tokens): card == "
        f"CPU in {equal} of {C16_REQS}, the others first differ at a near "
        f"tie ({worst:.3g} of the largest logit; limit {C16_NEAR_TIE:g}); "
        f"card paged decode launches {launches['card']}; {took:.1f} s")
    return launches["card"]


def e1_fault_plan():
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    return FaultPlan({0: (FaultSpec("hard_down", start=6.0, end=40.0),),
                      1: (FaultSpec("error_rate", rate=0.05),)}, seed=1)


def failure_plane_smoke(torch, np, dev, say, check):
    """E1: the failure plane on the float32 smoke pool, on the card and on
    the CPU.  Run 1: hedging after 4 chunks, endpoint 0 hard down over
    chunks [6, 40), endpoint 1 erroring at 0.05, health, 3 retries with
    backoff 2, the stall watchdog at 3 chunks.  Run 2: hedging after 2
    chunks against none.  Card and CPU must agree on the completed
    requests in order (id, endpoint, ``failed``, output), the counters,
    the trips and the breaker states; every allocator drains.  Returns
    the card's (paged decode, flash) launches."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import BalanceAware
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import (Endpoint, MultiLLMServer, Request,
                                            null_route_features)
    cfgs = [dataclasses.replace(get_smoke_config(a), dtype=torch.float32)
            for a in E1_POOL]
    host = [_f32(build_model(c).init(i, "cpu")) for i, c in enumerate(cfgs)]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 500, (9,)).astype(np.int32)
               for _ in range(E1_REQS)]
    runs = {"faults": (E1_NEW, lambda: dict(
                hedge_after_steps=4, fault_plan=e1_fault_plan(), health=True,
                retry_budget=3, backoff_steps=2.0, stall_after_chunks=3)),
            "hedge 2": (E1_HEDGE_NEW, lambda: dict(hedge_after_steps=2)),
            "hedge 0": (E1_HEDGE_NEW, lambda: {})}
    got, launches = {}, [0, 0]
    t0 = time.perf_counter()
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        for run, (max_new, kw) in runs.items():
            eps = [Endpoint(c, device=where, params=_tree_to(host[i], where),
                            **E1_EP) for i, c in enumerate(cfgs)]
            srv = MultiLLMServer(eps, BalanceAware(), batch_size=2, **kw())
            for rid, p in enumerate(prompts):
                srv.submit(Request(rid, p, max_new=max_new))
            pd_ops.launches = fa_ops.launches = 0
            done = srv.run(null_route_features, max_steps=600)
            if tag == "card":
                launches[0] += pd_ops.launches
                launches[1] += fa_ops.launches
            h = srv.health
            got[(tag, run)] = dict(
                trace=[(r.rid, r.endpoint, r.failed, tuple(r.output))
                       for r in done],
                counters=(srv.failures, srv.retries, srv.hedged),
                health=(h.trips, h.breaker_state.tolist()) if h else None)
            check(sorted(r.rid for r in done) == list(range(E1_REQS)),
                  f"E1 {run} ({tag}): a request was lost or repeated")
            check(all(_drained(e) for e in eps) and not srv._hedges
                  and not srv._shadow_ids,
                  f"E1 {run} ({tag}): an allocator did not drain")
    for run in runs:
        c, h = got[("card", run)], got[("cpu", run)]
        say(f"E1 {run}: failures, retries, hedged {c['counters']}; trips "
            f"and breaker states {c['health']}; completion order "
            f"{[t[0] for t in c['trace']]} (endpoints "
            f"{[t[1] for t in c['trace']]}); card == CPU {c == h}")
        check(c == h, f"E1 {run}: the card and the CPU differ")
    f = got[("card", "faults")]
    check(f["counters"][1] > 0 and f["health"][0] >= 1,
          "E1 faults: no retry or no breaker trip")
    hedged, plain = got[("card", "hedge 2")], got[("card", "hedge 0")]
    check(hedged["counters"][2] > 0 and sorted(hedged["trace"])
          == sorted(plain["trace"]),
          "E1 hedging: no hedge fired, or the outputs changed")
    say(f"E1: card launches (paged decode, flash) {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    check(launches[0] > 0 and launches[1] > 0,
          "E1: the card did not run the kernels")
    return launches


# -- the routed speculative stream ----------------------------------------------

def verify_mask(torch, lens, s_q, t, window, dev):
    """(B, 1, S, T) boolean mask of the verify rows: query s of sequence b
    sees positions < lens[b] + s (and >= lens[b] + s - window)."""
    pos = torch.arange(t, device=dev)
    n = lens.long()[:, None] + torch.arange(s_q, device=dev)[None, :]
    valid = pos[None, None, :] < n[:, :, None]
    if window > 0:
        valid = valid & (pos[None, None, :] >= n[:, :, None] - window)
    return valid[:, None]


def verify_kernel_phase(torch, say, check, dev):
    """V1: the verify kernel against its plain version at the serving head
    shapes, and each position against the decode kernel at lens + s, bit
    for bit (one split kernel: each row's operations do not depend on the
    other rows)."""
    from repro_torch.kernels.decode_attention.kernel import (
        paged_decode_attention_cuda, paged_verify_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import (
        paged_verify_attention_ref)
    err_max = 0.0
    for tag, b, s_q, kh, g, d, ps, p, window, lmax, dt in VERIFY_CASES:
        dtype = getattr(torch, dt)
        _, kp, vp, bt, lens = paged_inputs(torch, b, kh, g, d, ps, p, lmax,
                                           dtype, dev, seed=len(tag) + 100)
        # query 0 of each sequence at lens - S + 1: the last query position
        # reaches the sampled length
        lens = (lens - (s_q - 1)).clamp(min=1).to(torch.int32)
        gen = torch.Generator(device=dev).manual_seed(len(tag))
        q = torch.randn(b, s_q, kh * g, d, generator=gen, device=dev).to(dtype)
        got = paged_verify_attention_cuda(q, kp, vp, bt, lens, window=window)
        torch.cuda.synchronize()
        want = paged_verify_attention_ref(q, kp, vp, bt, lens, window=window)
        err = float((got.float() - want.float()).abs().max())
        if dt == "float32":
            ok = err <= 2e-5
        else:
            ok = torch.allclose(got.float(), want.float(), atol=1e-5,
                                rtol=2 ** -7)
        dec, same = 0.0, True
        for j in range(s_q):
            one = paged_decode_attention_cuda(
                q[:, j:j + 1].contiguous(), kp, vp, bt,
                (lens + j).to(torch.int32), window=window)
            same &= bool(torch.equal(one, got[:, j:j + 1]))
            dec = max(dec, float((one.float()
                                  - got[:, j:j + 1].float()).abs().max()))
        torch.cuda.synchronize()
        err_max = max(err_max, err)
        say(f"paged verify {tag}: B={b} S={s_q} K={kh} G={g} D={d} PS={ps} "
            f"P={p} window={window} lens {int(lens.min())}..{int(lens.max())}"
            f" {dt} | max|kernel-plain|={err:.3g}, max|verify[s] - decode "
            f"kernel at lens+s|={dec:.3g} (expected 0)")
        check(ok, f"paged verify {tag}: kernel disagrees with plain version")
        check(same, f"paged verify {tag}: verify row s differs from the "
              "decode kernel at lens + s")
    return err_max


class KeptCalls:
    """Stands in for the entry point ``module.name`` and, while ``on``,
    keeps every ``every``-th call: its inputs and what the path got, to
    hold them against the plain version after the run."""

    def __init__(self, module, name: str, every: int = 1):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.every, self.seen = every, 0
        self.calls, self.on = [], False
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        out = self.orig(*args, **kw)
        if self.on:
            if self.seen % self.every == 0:
                self.calls.append((args, kw, out))
            self.seen += 1
        return out

    def restore(self):
        setattr(self.module, self.name, self.orig)


def hold_blocked_calls(torch, say, check, calls, tag):
    """Holds the blocked ascent's kept calls to the plain version on the
    card, bit for bit: the output the path got and a fresh launch on the
    same inputs.  Returns (max |kernel - plain|, the calls whose 256-row
    blocks are fewer than the cluster's CTAs, so that some CTAs own none)."""
    from repro_torch.kernels.lagrangian_assign import kernel as la_kernel
    from repro_torch.kernels.lagrangian_assign.ref import (
        blocked_dual_ascent_ref)
    err, exact, sparse = 0.0, True, 0
    for args, kw, (path_out, _) in calls:
        got = la_kernel.blocked_dual_ascent_cuda(*args, **kw)
        ctas = la_kernel.cluster[0]
        want, _ = blocked_dual_ascent_ref(*args, **kw)
        shards = args[2].numel()
        blocks = shards * max(-(-(args[0].shape[0] // shards)
                                // la_kernel.STATS_ROWS), 1)
        sparse += blocks < ctas
        err = max(err, float((got - want).abs().max()),
                  float((path_out - want).abs().max()))
        exact = (exact and bool(torch.equal(got, want))
                 and bool(torch.equal(path_out, want)))
    say(f"{tag}: blocked dual ascent kernel vs plain version on the "
        f"{len(calls)} calls' inputs (the path's outputs and a fresh launch;"
        f" {sparse} with fewer 256-row blocks than CTAs): "
        f"max|kernel-plain|={err:.3g}, bit-identical {exact}")
    check(len(calls) > 0 and exact, f"{tag}: the blocked dual ascent "
          "kernel differs from its plain version")
    return err, sparse


def masked_solve_phase(torch, np, dev, say, check, time_ms, hp):
    """V2: the shard-statistics kernel against its plain version, and the
    padded, masked streaming solve with pair columns on the card (one
    launch of the blocked dual ascent a window) against the CPU plain path;
    the blocked ascent kernel against its plain version on every window's
    inputs.  Returns the kernels-line row of table row 4 (the blocked
    ascent, which took over the shard statistics' place on the path)."""
    from repro_torch.core import optimizer as opt
    from repro_torch.core.speculative import (AcceptanceTracker, SpecPair,
                                              expand_pair_columns,
                                              pair_index_arrays)
    from repro_torch.data import tokenizer
    from repro_torch.data.qaserve import generate
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.lagrangian_assign.kernel import (
        blocked_dual_ascent_cuda, shard_stats_cuda)
    from repro_torch.kernels.lagrangian_assign.ref import (
        blocked_dual_ascent_ref, shard_stats_ref)
    from repro_torch.analysis import kernel_work, roofline

    gen = torch.Generator(device=dev).manual_seed(11)
    err_max, exact = 0.0, True
    for n, lb in STATS_CASES:
        a = torch.rand(n, 8, generator=gen, device=dev)
        b = torch.rand(n, 8, generator=gen, device=dev) - 0.5
        lam = torch.tensor(0.7, device=dev)
        lam2 = torch.rand(8, generator=gen, device=dev) * 0.2
        nl = n // lb
        nv = torch.tensor([nl, nl - 37, 1000, 0][:lb], dtype=torch.float32,
                          device=dev)
        got = shard_stats_cuda(a, b, lam, lam2, nv, lblocks=lb)
        torch.cuda.synchronize()
        want = shard_stats_ref(a, b, lam, lam2, nv, lblocks=lb)
        err = float((got - want).abs().max())
        same = bool(torch.equal(got, want))
        exact = exact and same
        err_max = max(err_max, err)
        say(f"shard stats N={n} M=8 lblocks={lb} nv={nv.int().tolist()} | "
            f"max|kernel-plain|={err:.3g}, bit-identical {same}")
        check(bool(torch.equal(got[:, 2:], want[:, 2:])),
              f"shard stats N={n} lblocks={lb}: histogram differs")
        check(same, f"shard stats N={n} lblocks={lb}: sums differ from "
              "the plain version's bits")

    # the streaming run: ECCOS-H predictions of four windows, 6 base
    # columns + 2 pair columns, padded to power-of-two buckets
    n_all = sum(nv for nv, _ in STREAM_WINDOWS)
    ds = generate(n=n_all, seed=4)
    with torch.no_grad():
        cap, _, cost = hp.predict_device(
            hp.device_inputs(), torch.as_tensor(
                tokenizer.encode_batch(ds.queries, hp.token_len), device=dev),
            torch.as_tensor(ds.input_len, dtype=torch.float32, device=dev),
            torch.as_tensor(ds.price_in, dtype=torch.float32, device=dev),
            torch.as_tensor(ds.price_out, dtype=torch.float32, device=dev))
    pairs = (SpecPair(0, 1, k=8), SpecPair(3, 2, k=4))
    e_acc = torch.as_tensor(AcceptanceTracker(pairs).expected(),
                            dtype=torch.float32, device=dev)
    cost, cap = expand_pair_columns(cost, cap, *pair_index_arrays(pairs),
                                    e_acc)
    mp = cost.shape[1]
    windows, start = [], 0
    for nv, n_pad in STREAM_WINDOWS:
        c = torch.zeros(n_pad, mp, device=dev)
        q = torch.zeros(n_pad, mp, device=dev)
        c[:nv], q[:nv] = cost[start:start + nv], cap[start:start + nv]
        # garbage in the padding: the masked solve must not see it
        c[nv:], q[nv:] = 7.0, 0.5
        start += nv
        windows.append((c, q, nv))
    # the blocked ascent's calls on the card are kept, to hold the kernel
    # against its plain version on the same inputs below
    kept = KeptCalls(la_ops, "blocked_dual_ascent")
    fields = ("lam", "lam_load", "iters_run")
    for shards in (1, 4):
        runs = {}
        for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
            solver = opt.DualSolver(mode="quality", iters=150,
                                    lr_constraint=3.0, stall_tol=1e-2,
                                    norm_grad=True, shards=shards)
            state, out = None, []
            kept.on = tag == "card"
            for w, (c, q, nv) in enumerate(windows):
                loads = torch.full((mp,), float(nv // 4), device=where)
                before = (la_ops.blocked_launches, opt.solve_host_reads)
                st = {}
                t0 = time.perf_counter()
                x, info, state = solver.route_window(
                    c.to(where), q.to(where), 0.75, loads, state,
                    share=1.0 / (len(windows) - w), polish_margin=0.03,
                    n_valid=nv, stats=st)
                torch.cuda.synchronize()
                after = (la_ops.blocked_launches, opt.solve_host_reads)
                out.append(dict(
                    x=x[:nv].cpu(), wall=time.perf_counter() - t0,
                    solve_ms=st["solve_s"] * 1e3,
                    counts=[y - z for y, z in zip(after, before)],
                    spent=float(state.budget_spent),
                    **{f: getattr(info, f).cpu() for f in fields}))
            runs[tag] = out
        for w, (card, cpu) in enumerate(zip(runs["card"], runs["cpu"])):
            same = {f: bool(torch.equal(card[f], cpu[f]))
                    for f in ("x",) + fields}
            nv, n_pad = STREAM_WINDOWS[w]
            blocked_n, reads = card["counts"]
            say(f"masked stream shards={shards} window {w} ({nv} valid of "
                f"{n_pad}, M={mp}): card = CPU (torch.equal) {same}, "
                f"iters_run {int(card['iters_run'])}, lam "
                f"{float(card['lam']):.6g}; card solve "
                f"{card['solve_ms']:.3f} ms ({blocked_n} blocked-ascent "
                f"launch, {reads} host reads), window "
                f"{card['wall'] * 1e3:.1f} ms; CPU solve "
                f"{cpu['solve_ms']:.1f} ms ({cpu['counts'][1]} host reads);"
                f" ledger spent {card['spent']:.6f}/{cpu['spent']:.6f} $")
            for f, ok in same.items():
                check(ok, f"masked stream shards={shards} window {w}: {f} "
                      "differs between card and CPU")
            check(blocked_n == 1 and reads == 0,
                  f"masked stream shards={shards} window {w}: the solve "
                  "was not one blocked launch without host reads")
    kept.restore()

    # the blocked ascent kernel against its plain version (on the card)
    # on each window's inputs, as the solve passed them
    check(len(kept.calls) == 2 * len(windows),
          "masked stream: a window's solve was not kept")
    b_err, _ = hold_blocked_calls(torch, say, check, kept.calls,
                                  "masked stream")

    # the kernel at a window's shape (8,192 padded rows, M = 8, one shard)
    args, kw, _ = kept.calls[1]
    k_ms = time_ms(torch, lambda: blocked_dual_ascent_cuda(*args, **kw), 50)
    p_ms = time_ms(torch, lambda: blocked_dual_ascent_ref(*args, **kw), 3,
                   warm=1)
    out = blocked_dual_ascent_cuda(*args, **kw)
    it_run, nv_rows = int(out[6]), int(args[2].sum())
    nbytes, nops = kernel_work.blocked_ascent(nv_rows, args[2].numel(), mp,
                                              it_run)
    bound = roofline.bound_ms(nops, nbytes)
    say(f"blocked dual ascent kernel (window 1: {nv_rows} valid of "
        f"{args[0].shape[0]} rows, M={mp}, {it_run} iterations): "
        f"{k_ms:.4f} ms ({k_ms * 1e3 / max(it_run, 1):.3f} us/iteration) "
        f"with its wrapper, plain {p_ms:.1f} ms; bound {bound * 1e3:.3f} us"
        f" = max({nbytes / 1e3:.1f} KB / 3.35 TB/s, {nops / 1e6:.2f} MFLOP"
        f" [iters x rows x (4M+1)] / 67 TFLOP/s); library: none")

    # the per-iteration shard-statistics kernel at the same shape
    c, q, nv = windows[1]
    a = c.contiguous()
    b = (-q / float(nv)).contiguous()
    nvs = torch.tensor([float(nv)], device=dev)
    lam = torch.tensor(0.5, device=dev)
    lam2 = torch.zeros(mp, device=dev)
    s_ms = time_ms(torch, lambda: shard_stats_cuda(a, b, lam, lam2, nvs,
                                                   lblocks=1), 50)
    g_ms = graph_ms(torch, lambda: shard_stats_cuda(a, b, lam, lam2, nvs,
                                                    lblocks=1))
    s_bytes, s_ops = kernel_work.shard_stats(a.shape[0], mp, 1)
    s_bound = roofline.bound_ms(s_ops, s_bytes)
    say(f"shard stats kernel (N={a.shape[0]}, M={mp}, lblocks=1): "
        f"{s_ms * 1e3:.2f} us per call with its wrapper (two launches: "
        f"blocks, then the block sums in order), {g_ms * 1e3:.2f} us on the"
        f" device (replayed from a CUDA graph of {GRAPH_CALLS} calls), "
        f"bound {s_bound * 1e3:.3f} us; {it_run} such iterations were "
        f"{it_run * s_ms:.3f} ms of wrapper time before the blocked kernel")
    return dict(name="shard_stats", route="cuda",
                source="src/repro_torch/csrc/dual_solve.cu",
                entry="blocked_dual_ascent_launch",
                replaces="src/repro/kernels/lagrangian_assign/kernel.py:368",
                max_abs_err=b_err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                bound_by=roofline.bound_by(nops, nbytes), library_ms=None,
                iterations=it_run,
                per_iteration_kernel=dict(
                    source="src/repro_torch/csrc/shard_stats.cu",
                    ms=s_ms, graph_ms=g_ms, bound_ms=s_bound,
                    max_abs_err=err_max, bit_identical=exact))


def _graft(torch, verify, draft):
    """Verify params := the draft's blocks + zero-residual extra blocks
    (``wo`` and ``w_down`` zeroed), the draft's embeddings and final norm:
    the verify model computes the draft's function at the verify depth's
    cost (``benchmarks/bench_speculative.py:_graft``)."""
    out = dict(verify)
    for key in ("embed", "out_embed", "final_norm"):
        if key in verify and key in draft:
            out[key] = draft[key]

    def rec(v, d, key):
        if isinstance(v, dict):
            return {k: rec(v[k], d[k], k) for k in v}
        if isinstance(v, list):
            return [rec(a, b, key) for a, b in zip(v, d)]
        arr = torch.zeros_like(v) if key in ("wo", "w_down") else v.clone()
        arr[:d.shape[0]] = d
        return arr

    out["segs"] = [[rec(sv, sd, None) for sv, sd in zip(seg_v, seg_d)]
                   for seg_v, seg_d in zip(verify["segs"], draft["segs"])]
    return out


def _spec_prompts(np, cfg, n):
    rng = np.random.RandomState(0)
    return [rng.randint(1, cfg.vocab_size, (int(rng.randint(
        PROMPT_LO, PROMPT_HI + 1)),)).astype(np.int32) for _ in range(n)]


def spec_run(torch, np, d_ep, v_ep, prompts, max_new, k):
    """Decode ``prompts`` speculatively on (d_ep, v_ep); returns (outputs,
    server, decode seconds, per-round draft and verify seconds)."""
    from repro_torch.core.speculative import SpecPair
    from repro_torch.serving.engine import (MultiLLMServer, Request,
                                            _EngineExecutor)
    srv = MultiLLMServer([d_ep, v_ep], None, spec_pairs=(SpecPair(0, 1, k=k),))
    reqs = [Request(i, p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.admit_spec(r, 0)
    torch.cuda.synchronize()
    d_s, v_s = [], []

    def timed(fn, acc):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)          # returns host arrays: synced
            acc.append(time.perf_counter() - t0)
            return out
        return run

    d_ep.draft_round = timed(d_ep.draft_round, d_s)
    v_ep.verify_round = timed(v_ep.verify_round, v_s)
    ex = _EngineExecutor(srv, 100_000)
    t0 = time.perf_counter()
    try:
        while srv._spec:
            ex.advance(None)
        torch.cuda.synchronize()
    finally:
        del d_ep.draft_round, v_ep.verify_round
    return ([r.output for r in reqs], srv, time.perf_counter() - t0, d_s,
            v_s)


def strong_only_run(torch, v_ep, prompts, max_new):
    """The verify endpoint decoding ``prompts`` alone; returns (outputs,
    decode seconds)."""
    from repro_torch.serving.engine import Request
    reqs = [Request(100 + i, p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        v_ep.admit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while v_ep.active_count():
        v_ep.step()
    torch.cuda.synchronize()
    return [r.output for r in reqs], time.perf_counter() - t0


def _same_tokens(a, b):
    n = sum(len(x) for x in a)
    same = sum(int(u == v) for x, y in zip(a, b) for u, v in zip(x, y))
    return same / max(n, 1)


def _drained(ep):
    return (len(ep.alloc.free_pages) == ep.alloc.n_pages - 1
            and len(ep.alloc.free_slots) == ep.L and not ep.spec_slots
            and not ep.block_table.any())


def speculative_plane(torch, np, dev, say, check, time_ms):
    """V3, V4 and the float32 smoke spec pool card vs CPU.  Returns the
    kernels-line row of the paged verify kernel, and the blocked dual-ascent
    launches of the routed stream and their largest |kernel - plain|."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.analysis import sanitize
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import (BalanceAware, HybridPredictor, OmniRouter,
                                  PredictorConfig, RouterConfig)
    from repro_torch.core import optimizer as opt
    from repro_torch.core.speculative import SpecPair
    from repro_torch.data.qaserve import DEFAULT_POOL, generate
    from repro_torch.data.tokenizer import encode_for_config
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.decode_attention.kernel import (
        paged_verify_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import (
        gather_pages, paged_verify_attention_ref)
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import (Endpoint, MultiLLMServer, Request,
                                            null_route_features)
    from repro_torch.analysis import kernel_work

    cfg = get_config("h2o-danube-3-4b")
    dcfg = dataclasses.replace(cfg, n_layers=2)
    ep_kw = dict(max_concurrency=SPEC_REQS, t_max=2048, page_size=16,
                 sync_every=8, device=dev)
    v_params = build_model(cfg).init(0, dev)
    d_params = build_model(dcfg).init(7, dev)
    prompts = _spec_prompts(np, cfg, SPEC_REQS)

    # V3a. bf16, stock weights: the speculative pair at full width
    d_ep = Endpoint(dcfg, params=d_params, **ep_kw)
    v_ep = Endpoint(cfg, params=v_params, **ep_kw)
    pd_ops.verify_launches = 0
    pd_ops.launches = 0
    outs, srv, wall, d_s, v_s = spec_run(torch, np, d_ep, v_ep, prompts,
                                         SPEC_TOKENS, SPEC_K)
    v3_verify = pd_ops.verify_launches
    v_rounds = len(v_s)
    check(all(len(o) == SPEC_TOKENS for o in outs),
          "spec pair: a request did not get 128 tokens")
    check(srv.spec_emitted == SPEC_REQS * SPEC_TOKENS,
          "spec pair: spec_emitted != 1024")
    check(_drained(d_ep) and _drained(v_ep), "spec pair: allocator leak")
    check(v3_verify == cfg.n_layers * v_rounds,
          "spec pair: verify launches != 24 x verify rounds")
    spec_tps = SPEC_REQS * SPEC_TOKENS / wall
    # the verify kernel at the pair's shapes (the prompts' lens + 1)
    lens_v = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                             device=dev)
    so_ep = Endpoint(cfg, params=v_params, **ep_kw)
    so_outs, so_wall = strong_only_run(torch, so_ep, prompts, SPEC_TOKENS)
    so_tps = SPEC_REQS * SPEC_TOKENS / so_wall
    # the pools after the strong-only run still hold every prompt's K/V
    k_pool = so_ep._state["segs"][0][0]["k"][0]
    v_pool = so_ep._state["segs"][0][0]["v"][0]
    bt = torch.zeros((SPEC_REQS, so_ep.pages_per_slot), dtype=torch.int32)
    n_need = -(-(int(lens_v.max()) + SPEC_K) // 16)
    gen = torch.Generator().manual_seed(3)
    perm = torch.randperm(so_ep.alloc.n_pages - 1, generator=gen) + 1
    for i in range(SPEC_REQS):
        bt[i, :n_need] = perm[i * n_need:(i + 1) * n_need]
    bt = bt.to(dev)
    gq = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(SPEC_REQS, SPEC_K, cfg.n_heads, cfg.hd, generator=gq,
                    device=dev).to(cfg.dtype)
    window = cfg.sliding_window
    vk_ms = time_ms(torch, lambda: paged_verify_attention_cuda(
        q, k_pool, v_pool, bt, lens_v, window=window), 50)
    vk_dev = graph_ms(torch, lambda: paged_verify_attention_cuda(
        q, k_pool, v_pool, bt, lens_v, window=window))
    vp_ms = time_ms(torch, lambda: paged_verify_attention_ref(
        q, k_pool, v_pool, bt, lens_v, window=window), 10)
    kd = gather_pages(k_pool, bt).transpose(1, 2).contiguous()
    vd = gather_pages(v_pool, bt).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    mask = verify_mask(torch, lens_v, SPEC_K, kd.shape[2], window, dev)
    try:
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True), 50)
    except TypeError as exc:           # a PyTorch without enable_gqa
        say(f"  SDPA with enable_gqa unavailable: {exc}")
        lib_ms = None
    del kd, vd, so_ep
    nbytes, nops = kernel_work.verify_attention(
        lens_v.cpu(), q.shape[1], q.shape[2], cfg.n_kv_heads, cfg.hd, window,
        2, bt.numel())
    vbound, vbound_by = kernel_work.attention_bound(nbytes, nops, 2)
    d_med = float(np.median(d_s)) * 1e3
    v_med = float(np.median(v_s)) * 1e3
    say(f"spec pair (danube full width: verify 24 layers seed 0, draft 2 "
        f"layers seed 7; bf16, L={SPEC_REQS}, t_max 2048, PS 16, k="
        f"{SPEC_K}): {SPEC_REQS} x {SPEC_TOKENS} tokens, prompts "
        f"{min(map(len, prompts))}..{max(map(len, prompts))} | "
        f"{srv.spec_rounds} sequence rounds in {v_rounds} verify rounds, "
        f"{srv.spec_emitted / max(srv.spec_rounds, 1):.2f} tokens per "
        f"sequence round | {spec_tps:.1f} tokens/s; round draft {d_med:.1f} "
        f"ms + verify {v_med:.1f} ms (median) | strong-only verify endpoint "
        f"{so_tps:.1f} tokens/s on the same prompts | verify launches "
        f"{v3_verify} = {cfg.n_layers} x {v_rounds}")
    say(f"paged verify kernel at the pair's shapes (B={SPEC_REQS}, S="
        f"{SPEC_K}, lens {int(lens_v.min())}..{int(lens_v.max())}): "
        f"{vk_ms * 1e3:.1f} us/launch with the wrapper, {vk_dev * 1e3:.1f} "
        f"us on the device (CUDA graph), bound {vbound * 1e3:.1f} us = max("
        f"{nbytes / 1e6:.2f} MB / 3.35 TB/s, {nops / 1e9:.3f} GFLOP, Q.K "
        f"half at 989 TFLOP/s bf16, P.V half at 67 TFLOP/s fp32) -> "
        f"{vbound / vk_ms:.1%} of it; plain "
        f"{vp_ms * 1e3:.1f} us; SDPA (enable_gqa, boolean per-row mask) over "
        f"the pre-gathered K/V " + (f"{lib_ms * 1e3:.1f} us"
                                     if lib_ms is not None else "n/a")
        + f"; {cfg.n_layers} launches = "
        f"{vk_ms * cfg.n_layers / v_med:.1%} of a verify round")
    row = dict(name="paged_verify_attention", route="cuda",
               source="src/repro_torch/csrc/paged_decode.cu",
               replaces="src/repro/kernels/decode_attention/kernel.py:130",
               ms=vk_ms, plain_ms=vp_ms, bound_ms=vbound,
               bound_by=vbound_by, library_ms=lib_ms, graph_ms=vk_dev)

    # V4. the routed speculative stream, on the same endpoints
    pool = DEFAULT_POOL[:2]
    hp = HybridPredictor(PredictorConfig(n_models=2), seed=0, device=dev
                         ).fit_store(generate(n=8192, seed=0, pool=pool))
    ds = generate(n=ROUTED_SPEC_QUERIES, seed=3, pool=pool)
    with torch.no_grad():
        from repro_torch.data import tokenizer
        _, _, pcost = hp.predict_device(
            hp.device_inputs(), torch.as_tensor(tokenizer.encode_batch(
                ds.queries, hp.token_len), device=dev),
            torch.as_tensor(ds.input_len, dtype=torch.float32, device=dev),
            torch.as_tensor(ds.price_in, dtype=torch.float32, device=dev),
            torch.as_tensor(ds.price_out, dtype=torch.float32, device=dev))
    budget = 1.6 * float(pcost.min(dim=1).values.sum())
    pairs = (SpecPair(0, 1, k=SPEC_K),)
    arrive = np.cumsum(np.random.RandomState(0).exponential(
        1.0, ROUTED_SPEC_QUERIES))

    def v4_run():
        """One routed spec stream over d_ep and v_ep (drained between
        runs) with a fresh router; every solve's blocked ascent kept."""
        router = OmniRouter(hp, RouterConfig(budget=budget,
                                             spec_pairs=pairs))
        seen_nv = []
        route_window = router.route_window

        def logged(batch, state, **kw):
            seen_nv.append((kw.get("n_valid"), batch.n))
            return route_window(batch, state, **kw)

        router.route_window = logged
        srv = MultiLLMServer([d_ep, v_ep], router, stream=True,
                             window_steps=4, spec_pairs=pairs)
        for rid, text in enumerate(ds.queries):
            srv.submit(Request(rid, encode_for_config(cfg, text),
                               max_new=ROUTED_SPEC_TOKENS),
                       at_step=arrive[rid])
        kept = KeptCalls(la_ops, "blocked_dual_ascent")
        kept.on = True
        pd_ops.launches = pd_ops.verify_launches = 0
        la_ops.launches = la_ops.blocked_launches = 0
        reads0 = opt.solve_host_reads
        tr_ops.launches = 0
        t0 = time.perf_counter()
        try:
            served = srv.run(lambda b: ds.subset(np.array([r.rid
                                                           for r in b])))
            torch.cuda.synchronize()
        finally:
            kept.restore()
        wall = time.perf_counter() - t0
        v4 = dict(decode=pd_ops.launches, verify=pd_ops.verify_launches,
                  blocked=la_ops.blocked_launches,
                  solve_host_reads=opt.solve_host_reads - reads0,
                  vote=tr_ops.launches, dual_solve=la_ops.launches)
        return served, srv, router, seen_nv, v4, kept, wall

    served, srv, router, seen_nv, v4, kept, wall = v4_run()
    per_col = np.bincount([r.endpoint for r in served], minlength=3)
    state = srv._controller.state
    spent = float(state.budget_spent)
    not_pow2 = [nv for nv, _ in seen_nv if nv & (nv - 1)]
    say(f"routed spec stream (OmniRouter budget {budget:.6f} $ = 1.6 x "
        f"cheapest predicted, pair column (0 -> 1, k={SPEC_K}), "
        f"window_steps 4, {ROUTED_SPEC_QUERIES} queries x "
        f"{ROUTED_SPEC_TOKENS} tokens, Poisson 1/step): {len(served)} "
        f"served, per column {per_col.tolist()} (draft, verify, pair), "
        f"{srv.windows} windows with (n_valid, padded) {seen_nv}, dual iters"
        f" {srv.dual_iters}, {srv.spec_rounds} spec rounds, budget spent "
        f"{spent:.6f} $, wall {wall:.2f} s, route {srv.route_seconds:.2f} s"
        f" | launches {v4}")
    check(len(served) == ROUTED_SPEC_QUERIES and all(
        r.done and len(r.output) == ROUTED_SPEC_TOKENS for r in served),
          "routed spec stream: not every query served")
    check(srv.windows > 1 and len(not_pow2) > 0,
          "routed spec stream: no padded window of a non-power-of-two size")
    check(per_col[2] > 0, "routed spec stream: the pair column took none")
    check(int(router.acceptance.rounds.sum()) == srv.spec_rounds,
          "routed spec stream: acceptance rounds != spec rounds")
    check(spent <= budget, "routed spec stream: budget overspent")
    check(v4["solve_host_reads"] == 0,
          "routed spec stream: the solve read the host")
    check(len(kept.calls) == v4["blocked"],
          "routed spec stream: a blocked launch was not kept")
    blocked_err, sparse = hold_blocked_calls(torch, say, check, kept.calls,
                                             "routed spec stream")
    check(sparse > 0, "routed spec stream: no window left a CTA of the "
          "cluster without a block")
    check(v4["blocked"] > 0 and v4["verify"] > 0 and v4["decode"] > 0
          and v4["vote"] > 0, "routed spec stream: a kernel never ran")
    check(_drained(d_ep) and _drained(v_ep),
          "routed spec stream: allocator leak")

    # G2 (spec stream). the same stream with LedgerSan and SolveCert on:
    # every window certified, the ledger checked, the same outputs
    def outcome(served_, srv_):
        return (sorted((r.rid, r.endpoint, tuple(r.output))
                       for r in served_),
                srv_.windows, srv_.dual_iters, srv_.spec_rounds,
                float(srv_._controller.state.budget_spent))

    with sanitize.enabled("ledgersan", "solvecert"):
        c0 = dict(sanitize.counters)
        g_served, g_srv, _, g_nv, g_v4, _, g_wall = v4_run()
        moved = {k: sanitize.counters[k] - c0[k] for k in c0}
    same = outcome(g_served, g_srv) == outcome(served, srv)
    g2_spec = dict(windows=g_srv.windows, certs=moved["certs"],
                   checks=moved["checks"], same=same, wall=g_wall,
                   launches=g_v4)
    say(f"G2 routed spec stream with LedgerSan + SolveCert: "
        f"{g_srv.windows} windows, {moved['certs']} certificates, "
        f"{moved['checks']} ledger checks, no violation; outputs, windows, "
        f"dual iters, spec rounds and ledger equal to the sanitizer-off "
        f"run: {same}; wall {g_wall:.2f} s (off {wall:.2f} s); launches "
        f"{g_v4}")
    check(moved["certs"] == g_srv.windows
          and moved["checks"] >= g_srv.windows,
          "G2 spec stream: a window went uncertified or unchecked")
    check(same, "G2 spec stream: the sanitized run differs")
    check(_drained(d_ep) and _drained(v_ep),
          "G2 spec stream: allocator leak")
    row["launches"] = v3_verify + v4["verify"] + g_v4["verify"]
    say(f"paged verify launches on the main path: spec pair {v3_verify}, "
        f"routed stream {v4['verify']}, G2 {g_v4['verify']}")
    del d_ep, v_ep, srv, g_srv, hp, router

    # V3b. graft: the verify model = the draft's 2 blocks + 22 zero-residual
    # blocks, so nearly every draft is accepted
    g_params = _graft(torch, v_params, d_params)
    d_ep = Endpoint(dcfg, params=d_params, **ep_kw)
    v_ep = Endpoint(cfg, params=g_params, **ep_kw)
    g_outs, g_srv, g_wall, _, g_v = spec_run(torch, np, d_ep, v_ep, prompts,
                                             SPEC_TOKENS, SPEC_K)
    so_ep = Endpoint(cfg, params=g_params, **ep_kw)
    gso_outs, gso_wall = strong_only_run(torch, so_ep, prompts, SPEC_TOKENS)
    g_emit = g_srv.spec_emitted / max(g_srv.spec_rounds, 1)
    g_same = _same_tokens(g_outs, gso_outs)
    say(f"graft pair (verify = draft's 2 blocks + 22 zero-residual blocks, "
        f"bf16): {g_emit:.2f} tokens per sequence round (limit >= "
        f"{GRAFT_EMIT * SPEC_K:.1f}), {len(g_v)} verify rounds, "
        f"{SPEC_REQS * SPEC_TOKENS / g_wall:.1f} tokens/s vs strong-only "
        f"{SPEC_REQS * SPEC_TOKENS / gso_wall:.1f} tokens/s; tokens equal "
        f"to strong-only {g_same:.4f} (limit >= {ID_LIMIT})")
    check(g_emit >= GRAFT_EMIT * SPEC_K, "graft pair: too few tokens a round")
    check(g_same >= ID_LIMIT, "graft pair: output differs from strong-only")
    del d_ep, v_ep, so_ep, g_params, v_params, d_params

    # V3c. identity held to limits: float32, wq/wk rescaled to unit-std
    # scores (the full-width check's weights), junk draft (other seed)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    dcfg32 = dataclasses.replace(dcfg, dtype=torch.float32)
    v32 = _unit_fan_in(_f32(build_model(cfg32).init(0, dev)))
    d32 = _unit_fan_in(_f32(build_model(dcfg32).init(7, dev)))
    d_ep = Endpoint(dcfg32, params=d32, **ep_kw)
    v_ep = Endpoint(cfg32, params=v32, **ep_kw)
    i_outs, i_srv, _, _, _ = spec_run(torch, np, d_ep, v_ep, prompts,
                                      ID_TOKENS, SPEC_K)
    del d_ep, v_ep
    so_ep = Endpoint(cfg32, params=v32, **ep_kw)
    iso_outs, _ = strong_only_run(torch, so_ep, prompts, ID_TOKENS)
    i_same = _same_tokens(i_outs, iso_outs)
    say(f"identity (float32, unit-std scores, 24-layer verify, junk "
        f"2-layer draft): {SPEC_REQS} x {ID_TOKENS} tokens, "
        f"{i_srv.spec_emitted / max(i_srv.spec_rounds, 1):.2f} tokens per "
        f"round; speculative tokens equal to strong-only {i_same:.4f} "
        f"(limit >= {ID_LIMIT}, 1.0 expected)")
    check(i_same >= ID_LIMIT, "identity: speculative output differs from "
          "the verify model alone")
    del so_ep, v32, d32

    # S6 (spec). a float32 smoke speculative pool, card vs CPU
    scfg = dataclasses.replace(get_smoke_config("h2o-danube-3-4b"),
                               dtype=torch.float32)
    host = [_f32(build_model(scfg).init(seed, "cpu")) for seed in (7, 0)]
    rng = np.random.RandomState(8)
    todo = [(rng.randint(1, 512, (int(rng.randint(2, 30)),)).astype(np.int32),
             int(rng.randint(4, 17))) for _ in range(SPEC_CPU_REQS)]
    runs = []
    for where in (dev, torch.device("cpu")):
        eps = [Endpoint(scfg, max_concurrency=3, t_max=64, page_size=8,
                        sync_every=4, device=where,
                        params=_tree_to(host[i], where)) for i in range(2)]
        srv = MultiLLMServer(eps, BalanceAware(),
                             spec_pairs=(SpecPair(0, 1, k=3),))
        for rid, (toks, m) in enumerate(todo):
            srv.submit(Request(rid, toks, max_new=m))
        runs.append(({r.rid: (r.endpoint, list(r.output))
                      for r in srv.run(null_route_features)},
                     srv.spec_rounds))
    (card, c_rounds), (host_run, h_rounds) = runs
    same = np.mean([card[i] == host_run[i] for i in range(SPEC_CPU_REQS)])
    n_pair = sum(1 for e, _ in card.values() if e == 2)
    say(f"smoke spec pool float32 (2 x danube smoke + pair k=3, "
        f"BalanceAware), card vs CPU ({SPEC_CPU_REQS} requests, {n_pair} "
        f"on the pair column, {c_rounds}/{h_rounds} spec rounds): same "
        f"(endpoint, output) {same:.4f}")
    check(len(card) == len(host_run) == SPEC_CPU_REQS and n_pair > 0,
          "spec pool card vs CPU: a request lost or no pair request")
    check(same == 1.0, "spec pool card vs CPU: outputs differ")
    return row, v4["blocked"] + g2_spec["launches"]["blocked"], blocked_err, \
        g2_spec


def sdpa_ms(torch, F, say, time_ms, q, k, v, mask=None, causal=False,
            reps=20):
    """One ``scaled_dot_product_attention`` call on the (B, H, S, D)
    layout (the transposes outside the clock), or None without
    ``enable_gqa``."""
    qd, kd, vd = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    try:
        return time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, is_causal=causal, enable_gqa=True),
            reps)
    except TypeError as exc:          # a PyTorch without enable_gqa
        say(f"  SDPA with enable_gqa unavailable: {exc}")
        return None


def sass_hmma(lib, ops=("HMMA", "HGMMA")):
    """{kernel function: tensor-core instructions} of the built library
    ``csrc/<lib>.cu``, from ``cuobjdump --dump-sass`` beside ``nvcc``: the
    lines holding any of ``ops`` (HMMA: ``mma.sync``; HGMMA: ``wgmma``)."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(_build._target(lib))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and any(op in line for op in ops):
            counts[fn] += 1
    return counts


def flash_kernel_phase(torch, np, say, check, dev, time_ms):
    """F1: the flash kernel against the chunked plain version and the dense
    float32 ``flash_attention_ref``.  Both the kernel and the chunked
    version round p to the operand type relative to the running max, so
    they round at the same points only over the same chunks: the kernel
    updates its max once per ``softmax_step`` positions (64 in bf16 on the
    tensor cores, 32 in float32), the CPU path's default every 512 (or the
    gcd fallback's divisor).  bf16: all but a share FLASH_ULP_SHARE of
    the elements within one bf16 ulp of the chunked version run over the
    kernel's chunks (keys zero-padded to a multiple of the step and masked
    past Skv), and 2e-2 from it, from the reference (which keeps p in
    float32) and from the default chunking; float32 (rounding p is exact):
    2e-5 from all three.  The built library's SASS must hold
    HMMA (tensor-core) instructions in the bf16 kernel and none in the
    float32 one.  Returns the kernels-line row at the main path's shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, softmax_step)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_chunked, flash_attention_ref)
    from repro_torch.analysis import kernel_work, roofline
    hmma = sass_hmma("flash_attention")
    say(f"flash SASS: HMMA instructions per kernel {hmma}")
    check(any(n > 0 for f, n in hmma.items() if "flash_tc_kernel" in f)
          and all(n == 0 for f, n in hmma.items() if "flash_kernel" in f),
          "flash: the bf16 kernel has no HMMA or the float32 kernel has")
    err_max, row = 0.0, None
    for i, (tag, b, s, skv, kh, g, d, window, q_off, causal, dt) in \
            enumerate(FLASH_CASES):
        dtype = getattr(torch, dt)
        h = kh * g
        gen = torch.Generator(device=dev).manual_seed(40 + i)
        q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, skv, kh, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, skv, kh, d, generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        got = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        step = softmax_step(d, dtype)
        pad = -skv % step
        kp, vp = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (k, v))
        tiled = flash_attention_chunked(q, kp, vp, kv_chunk=step,
                                        kv_valid=skv, **kw)
        # the plain version's time: the median of two calls after this
        # one, which warms them up (at S 1,535 its gcd fallback runs 1,535
        # chunks, 2.5 s a call)
        plain = flash_attention_chunked(q, k, v, **kw)
        p_ms = time_ms(torch, lambda: flash_attention_chunked(q, k, v, **kw),
                       2, warm=0)
        # the reference has no q_offset: zero rows in front, sliced away
        qf = torch.cat([q.new_zeros(b, q_off, h, d), q], 1) if q_off else q
        ref = flash_attention_ref(qf, k, v, causal=causal,
                                  window=window)[:, q_off:]
        e_tiled = float((got.float() - tiled.float()).abs().max())
        e_plain = float((got.float() - plain.float()).abs().max())
        e_ref = float((got.float() - ref.float()).abs().max())
        # elements beyond one bf16 ulp of the chunked version at the step
        n_ulp = int((~torch.isclose(got.float(), tiled.float(), atol=1e-5,
                                    rtol=2 ** -7)).sum())
        share = n_ulp / got.numel()
        del ref, qf, kp, vp
        if dt == "float32":
            ok = max(e_tiled, e_plain, e_ref) <= 2e-5
        else:
            ok = (share <= FLASH_ULP_SHARE and e_tiled <= 2e-2
                  and e_ref <= 2e-2 and e_plain <= 2e-2)
        err_max = max(err_max, e_tiled)
        k_ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw),
                       10)
        masked = causal and (0 < window < skv or q_off > 0)
        sdpa_kind = ("boolean mask" if masked else
                     "is_causal" if causal else "no mask")
        if masked:
            pos = torch.arange(skv, device=dev)
            qp = q_off + torch.arange(s, device=dev)
            mask = (pos[None, :] <= qp[:, None])
            if window > 0:
                mask &= pos[None, :] > qp[:, None] - window
            lib = sdpa_ms(torch, F, say, time_ms, q, k, v, mask=mask, reps=10)
        else:
            lib = sdpa_ms(torch, F, say, time_ms, q, k, v, causal=causal,
                          reps=10)
        elem = q.element_size()
        nbytes, nops = kernel_work.flash_forward(b, s, skv, h, kh, d, window,
                                                 q_off, elem, causal)
        bound = roofline.bound_ms(nops, nbytes, kernel_work.peak_for(elem))
        bound_by = roofline.bound_by(nops, nbytes, kernel_work.peak_for(elem))
        say(f"flash {tag}: B={b} S={s} Skv={skv} K={kh} G={g} D={d} "
            f"window={window} q_offset={q_off} causal={causal} {dt} | "
            f"max|kernel-chunked at "
            f"{step}|={e_tiled:.3g} ({n_ulp} of {got.numel()} elements = "
            f"{share:.2e} beyond one bf16 ulp), at the default chunk="
            f"{e_plain:.3g}, "
            f"max|kernel-ref|={e_ref:.3g} | kernel "
            f"{k_ms * 1e3:.1f} us, bound {bound * 1e3:.1f} us = max("
            f"{nbytes / 1e6:.2f} MB / 3.35 TB/s, {nops / 1e9:.2f} GFLOP / "
            f"{'989 TFLOP/s bf16' if elem == 2 else '67 TFLOP/s fp32'}) -> "
            f"{bound / k_ms:.1%} of it; chunked plain {p_ms * 1e3:.1f} us; "
            f"SDPA ({sdpa_kind}, enable_gqa)"
            f" " + (f"{lib * 1e3:.1f} us" if lib is not None else "n/a"))
        check(ok, f"flash {tag}: kernel disagrees with its plain versions")
        if i == FLASH_MAIN:
            row = dict(name="flash_attention", route="cuda",
                       source="src/repro_torch/csrc/flash_attention.cu",
                       replaces="src/repro/kernels/flash_attention/kernel.py:77",
                       ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                       bound_by=bound_by, library_ms=lib)
        if i == FLASH_D64:
            d64 = dict(shape=tag, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                       bound_by=bound_by, library_ms=lib)
        del q, k, v, got, plain, tiled
    row["max_abs_err"] = err_max
    row["d64"] = d64
    return row


def dense_decode_phase(torch, say, check, dev, time_ms):
    """D1: the dense decode kernel against ``decode_attention_ref`` (the
    bounds of S2) and against the paged decode kernel on the same rows laid
    out as 16-position pages with an identity block table: the same split
    boundaries, so exactly 0.  Then the same entry point at SPEC_K
    positions (the dense verify) against ``verify_attention_ref`` (S2's
    bounds), the paged verify kernel over the same pages and, row s, the
    dense decode at lens + s (both exactly 0).  Returns the kernels-line
    row at the main path's shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, paged_decode_attention_cuda,
        paged_verify_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, verify_attention_ref)
    from repro_torch.analysis import kernel_work
    err_max, row = 0.0, None
    for i, (tag, b, t, kh, g, d, window, lens, dt) in enumerate(
            DENSE_CASES):
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(60 + i)
        q = torch.randn(b, 1, kh * g, d, generator=gen, device=dev).to(dtype)
        kc = torch.randn(b, t, kh, d, generator=gen, device=dev).to(dtype)
        vc = torch.randn(b, t, kh, d, generator=gen, device=dev).to(dtype)
        if isinstance(lens, tuple):
            cpu = torch.Generator().manual_seed(i)
            ln = torch.randint(lens[0], lens[1] + 1, (b,), generator=cpu)
            ln[0], ln[-1] = lens
            ln = ln.to(torch.int32).to(dev)
        elif lens:
            ln = torch.full((b,), lens, dtype=torch.int32, device=dev)
        else:
            cpu = torch.Generator().manual_seed(i)
            ln = torch.randint(1, t + 1, (b,), generator=cpu)
            ln[0], ln[-1] = 1, t
            ln = ln.to(torch.int32).to(dev)
        got = decode_attention_cuda(q, kc, vc, ln, window=window)
        torch.cuda.synchronize()
        want = decode_attention_ref(q, kc, vc, ln, window=window)
        err = float((got.float() - want.float()).abs().max())
        if dt == "float32":
            ok = err <= 2e-5
        else:
            ok = torch.allclose(got.float(), want.float(), atol=1e-5,
                                rtol=2 ** -7)
        ps = 16
        n_pg = -(-t // ps)
        kp, vp = (F.pad(x, (0, 0, 0, 0, 0, n_pg * ps - t)).reshape(
            b * n_pg, ps, kh, d) for x in (kc, vc))
        bt = torch.arange(b * n_pg, dtype=torch.int32,
                          device=dev).reshape(b, n_pg)
        paged = paged_decode_attention_cuda(q, kp, vp, bt, ln, window=window)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, paged))
        diff = float((got.float() - paged.float()).abs().max())
        err_max = max(err_max, err)
        say(f"dense decode {tag}: B={b} T={t} K={kh} G={g} D={d} "
            f"window={window} lens {int(ln.min())}..{int(ln.max())} {dt} | "
            f"max|kernel-plain|={err:.3g}, max|dense - paged kernel "
            f"(identity pages)|={diff:.3g} (expected 0)")
        check(ok, f"dense decode {tag}: kernel disagrees with plain version")
        check(same, f"dense decode {tag}: differs from the paged kernel")
        # the dense verify: query s attends to positions < lv + s <= T
        qv = torch.randn(b, SPEC_K, kh * g, d, generator=gen,
                         device=dev).to(dtype)
        lv = torch.clamp(ln - (SPEC_K - 1), min=1)
        gv = decode_attention_cuda(qv, kc, vc, lv, window=window)
        pv = paged_verify_attention_cuda(qv, kp, vp, bt, lv, window=window)
        rows = torch.cat([decode_attention_cuda(
            qv[:, j:j + 1].contiguous(), kc, vc, lv + j, window=window)
            for j in range(SPEC_K)], dim=1)
        torch.cuda.synchronize()
        wv = verify_attention_ref(qv, kc, vc, lv, window=window)
        errv = float((gv.float() - wv.float()).abs().max())
        if dt == "float32":
            okv = errv <= 2e-5
        else:
            okv = torch.allclose(gv.float(), wv.float(), atol=1e-5,
                                 rtol=2 ** -7)
        err_max = max(err_max, errv)
        say(f"dense verify {tag}: S={SPEC_K}, lens {int(lv.min())}.."
            f"{int(lv.max())} | max|kernel-plain|={errv:.3g}; equal to the "
            f"paged verify kernel (identity pages): "
            f"{bool(torch.equal(gv, pv))}, row s to the dense decode at "
            f"lens + s: {bool(torch.equal(gv, rows))} (expected both)")
        check(okv, f"dense verify {tag}: kernel disagrees with plain version")
        check(bool(torch.equal(gv, pv)) and bool(torch.equal(gv, rows)),
              f"dense verify {tag}: differs from the paged verify or from "
              "the dense decode at lens + s")
        del kp, vp, qv, gv, pv, rows
        if i == DENSE_MAIN:
            k_ms = time_ms(torch, lambda: decode_attention_cuda(
                q, kc, vc, ln, window=window), 50)
            k_dev = graph_ms(torch, lambda: decode_attention_cuda(
                q, kc, vc, ln, window=window))
            p_ms = time_ms(torch, lambda: decode_attention_ref(
                q, kc, vc, ln, window=window), 10)
            pos = torch.arange(t, device=dev)
            mask = pos[None, :] < ln[:, None].long()
            if window > 0:
                mask &= pos[None, :] >= ln[:, None].long() - window
            lib = sdpa_ms(torch, F, say, time_ms, q, kc, vc,
                          mask=mask[:, None, None, :], reps=50)
            elem = q.element_size()
            nbytes, nops = kernel_work.decode_attention(
                ln.cpu(), q.shape[2], kh, d, window, elem)
            bound, bound_by = kernel_work.attention_bound(nbytes, nops, elem)
            say(f"dense decode kernel at R1's decode shape: {k_ms * 1e3:.1f}"
                f" us/launch with the wrapper, {k_dev * 1e3:.1f} us on the "
                f"device (CUDA graph), bound {bound * 1e3:.1f} us = max("
                f"{nbytes / 1e6:.2f} MB / 3.35 TB/s, {nops / 1e9:.3f} GFLOP, "
                f"Q.K half at 989 TFLOP/s bf16, P.V half at 67 TFLOP/s fp32)"
                f" -> {bound / k_ms:.1%} of it; plain {p_ms * 1e3:.1f} us; "
                f"SDPA (enable_gqa, boolean length mask) "
                + (f"{lib * 1e3:.1f} us" if lib is not None else "n/a"))
            row = dict(name="decode_attention", route="cuda",
                       source="src/repro_torch/csrc/paged_decode.cu",
                       replaces="src/repro/kernels/decode_attention/kernel.py:68",
                       ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                       bound_by=bound_by, library_ms=lib, graph_ms=k_dev)
        del q, kc, vc
    row["max_abs_err"] = err_max
    return row


# -- the retrieval kernel (3a, 3c), neighbour-only top-k and the one-step
# assignment (slice 5) ---------------------------------------------------------

TOPK_KMAX = 64          # the retrieval kernel's largest k (paper Table 4)
DUP_ODD = 4_133         # 3c: a duplicated store at an offset of no tile
STEP_N = 1_000          # assign step: a batch that is not a block multiple
STEP_M = 16             # assign step: the kernel's largest model count
SEED_N = 16_384         # 3e: the seed loop of benchmarks/bench_routing.py
SEED_M = 6
SEED_ALPHA = 0.7
SEED_ITERS = 150
SEED_REPS = 5


def retrieval_row(name, replaces, launches, err, b, n_rows, d, k, n_lab,
                  ms, plain_ms, lib_ms, say, tag):
    """Print the timing line at the route batch and return the kernels-line
    row: its bound is the 3xTF32 one, the design that runs; the float32
    CUDA-core bound rides beside it."""
    from repro_torch.analysis import kernel_work, roofline
    nbytes, nops = kernel_work.retrieval(b, n_rows, d, k, n_lab)
    fp32_ms, tf32_ms = kernel_work.retrieval_bounds(b, n_rows, d, k, n_lab)
    say(f"{tag} timing (B={b}, N_db={n_rows}, d={d}, k={k}): kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul of the same "
        f"fp32 product {lib_ms:.3f} ms; bounds: 3xTF32 on the tensor cores "
        f"{tf32_ms:.3f} ms = max({nbytes / 1e6:.1f} MB / 3.35 TB/s, 3 x "
        f"{nops / 1e12:.3f} TFLOP / 495 TFLOP/s TF32), float32 on the CUDA "
        f"cores {fp32_ms:.3f} ms (/ 67 TFLOP/s) | kernel at "
        f"{tf32_ms / ms:.1%} of the 3xTF32 bound")
    return dict(name=name, route="cuda",
                source="src/repro_torch/csrc/retrieval_vote.cu",
                replaces=replaces, launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=tf32_ms,
                bound_by=roofline.bound_by(3 * nops, nbytes,
                                           roofline.PEAK_TF32),
                library_ms=lib_ms, bound_fp32_ms=fp32_ms)


def window_timing(torch, say, time_ms, fn, q_route, emb, n_valid, d, k,
                  n_lab, tag):
    """The kernel at the stream window's batch (N_WINDOW queries) beside
    its bounds and ``torch.matmul``; returns the row's window keys."""
    from repro_torch.analysis import kernel_work
    q_win = q_route[:N_WINDOW].contiguous()
    ms = time_ms(torch, lambda: fn(q_win), REPS)
    store_t = emb[:n_valid].T
    lib = time_ms(torch, lambda: torch.matmul(q_win, store_t), REPS)
    fp32_ms, tf32_ms = kernel_work.retrieval_bounds(N_WINDOW, n_valid, d, k,
                                                    n_lab)
    say(f"{tag} timing at the stream window (B={N_WINDOW}): kernel "
        f"{ms:.3f} ms, torch.matmul {lib:.3f} ms; bounds 3xTF32 "
        f"{tf32_ms:.3f} ms, float32 {fp32_ms:.3f} ms | kernel at "
        f"{tf32_ms / ms:.1%} of the 3xTF32 bound")
    return dict(window_b=N_WINDOW, window_ms=ms, window_library_ms=lib,
                window_bound_ms=tf32_ms, window_bound_fp32_ms=fp32_ms)


def retrieval_case(torch, say, check, store, q, kk, nv, labs=None,
                   exact=False, tag="", out=None):
    """The retrieval kernel against its plain version on one input: the
    vote entry point when ``labs`` is given, else top-k (or ``out``, an
    entry point's result on these inputs).  vals within 1e-5, sorted index
    rows equal on >= 0.999, exact order where asked, (NEG_INF, -1) past the
    valid rows; votes within 1e-5 relative to max(1, |vote|) on the rows
    whose index sets agree (they hold output lengths up to 1024 beside 0/1
    correctness; one float32 ulp at 1024 is 6e-5).  Returns the largest
    error."""
    from repro_torch.kernels.topk_retrieval.kernel import (
        retrieval_vote_cuda, topk_retrieval_cuda)
    from repro_torch.kernels.topk_retrieval.ref import (
        NEG_INF, retrieval_vote_ref, topk_retrieval_ref)
    if out is None:
        out = (retrieval_vote_cuda(store, labs, q, kk, nv) if labs is not None
               else topk_retrieval_cuda(store, q, kk, nv))
    torch.cuda.synchronize()
    ref = (retrieval_vote_ref(store, labs, q, kk, nv) if labs is not None
           else topk_retrieval_ref(store, q, kk, nv))
    (kv, ki), (rv, ri) = out[:2], ref[:2]
    what = f"{'vote' if labs is not None else 'top-k'} {tag}"
    err = err_vals = (kv - rv).abs().max().item()
    same_rows = (torch.sort(ki, 1).values == torch.sort(ri, 1).values)
    agree = same_rows.float().mean().item()
    line = (f"{what}: B={q.shape[0]} N_db={store.shape[0]} k={kk} "
            f"n_valid={nv} | max|dvals|={err:.3g} idx agree={agree:.6f}")
    rel = 0.0
    if labs is not None:
        rows = same_rows.all(1)
        dvote = (out[2] - ref[2])[rows].abs()
        scale = torch.clamp(ref[2][rows].abs(), min=1.0)
        err_vote = dvote.max().item() if rows.any() else 0.0
        rel = (dvote / scale).max().item() if rows.any() else 0.0
        line += f" max|dvote|={err_vote:.3g} (relative {rel:.3g})"
        err = max(err, err_vote)
    say(line)
    check(err_vals <= 1e-5, f"{what} vals")
    check(agree >= 0.999, f"{what} idx sets")
    check(rel <= 1e-5, f"{what} votes")
    if exact:
        check(bool((ki == ri).all()), f"{what} exact idx order")
    live = min(nv, store.shape[0])
    if kk > live:
        check(bool((ki[:, live:] == -1).all()
                   and (kv[:, live:] <= NEG_INF * 0.5).all()),
              f"{what} empty slots")
    return err


def k_refused(fn, what, check):
    """k = TOPK_KMAX + 1 must raise before any launch."""
    try:
        fn(TOPK_KMAX + 1)
        refused = False
    except ValueError:
        refused = True
    check(refused, f"{what} k={TOPK_KMAX + 1} was not refused")


def vote_phase(torch, say, check, time_ms, emb, labels, q_route, k,
               n_valid):
    """3a: the vote entry point against its plain version on all of the
    route batch's rows and on the edge cases (n_valid inside the store,
    k > n_valid, a duplicated store in exact order, k = 64, a 700-row
    store, k = 65 refused); its times at the route batch and the stream
    window.  Returns the kernels-line row (launches filled in by phase 4)."""
    from repro_torch.kernels.topk_retrieval.kernel import retrieval_vote_cuda
    from repro_torch.kernels.topk_retrieval.ref import retrieval_vote_ref

    def case(store, labs, q, kk, nv, **kw):
        return retrieval_case(torch, say, check, store, q, kk, nv, labs=labs,
                              **kw)

    q_cmp = q_route[:CMP_QUERIES]
    dup = torch.cat([emb[:4096], emb[:4096]]).contiguous()
    dup_lab = torch.cat([labels[:4096], labels[:4096]]).contiguous()
    err = max(
        case(emb, labels, q_route, k, n_valid, tag="full store, all rows"),
        case(emb, labels, q_cmp, 16, 100_003, tag="n_valid"),
        case(emb[:10].contiguous(), labels[:10].contiguous(), q_cmp, 16, 10,
             tag="k>n_valid"),
        case(dup, dup_lab, q_cmp, 16, 8192, exact=True,
             tag="duplicated rows"),
        case(emb, labels, q_cmp, TOPK_KMAX, n_valid, tag="k=64"),
        case(emb[:700].contiguous(), labels[:700].contiguous(), q_cmp, k, 700,
             tag="700-row store"))
    del dup, dup_lab
    k_refused(lambda kk: retrieval_vote_cuda(emb, labels, q_cmp, kk,
                                             n_valid), "vote", check)

    ms = time_ms(torch, lambda: retrieval_vote_cuda(emb, labels, q_route, k,
                                                    n_valid), REPS)
    plain_ms = time_ms(torch, lambda: retrieval_vote_ref(
        emb, labels, q_route, k, n_valid), 3, warm=1)
    store_t = emb[:n_valid].T
    lib_ms = time_ms(torch, lambda: torch.matmul(q_route, store_t), REPS)
    del store_t
    d, n_lab = emb.shape[1], labels.shape[1]
    row = retrieval_row("retrieval_vote",
                        "src/repro/kernels/topk_retrieval/kernel.py:185",
                        None, err, N_ROUTE, n_valid, d, k, n_lab, ms,
                        plain_ms, lib_ms, say, "vote")
    row.update(window_timing(
        torch, say, time_ms,
        lambda q: retrieval_vote_cuda(emb, labels, q, k, n_valid), q_route,
        emb, n_valid, d, k, n_lab, "vote"))
    return row


def topk_phase(torch, say, check, time_ms, emb, labels, q_route, k,
               n_valid):
    """3c: the top-k entry point against its plain version on 3a's cases,
    and on a store duplicated at an offset of no tile multiple (identical
    rows must give bit-equal values in any tile position and slice); the
    entry point at the full route batch (the main path of this kernel,
    launches counted), bit for bit equal to the vote entry point's
    (vals, idx), every row held to the plain version; its times at the
    route batch and the stream window.  Returns the kernels-line row."""
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    from repro_torch.kernels.topk_retrieval.kernel import (
        retrieval_vote_cuda, topk_retrieval_cuda)
    from repro_torch.kernels.topk_retrieval.ref import topk_retrieval_ref

    def case(store, q, kk, nv, **kw):
        return retrieval_case(torch, say, check, store, q, kk, nv, **kw)

    q_cmp = q_route[:CMP_QUERIES]
    dup = torch.cat([emb[:4096], emb[:4096]]).contiguous()
    err = max(case(emb, q_cmp, k, n_valid, tag="full store"),
              case(emb, q_cmp, 16, 100_003, tag="n_valid"),
              case(emb[:10].contiguous(), q_cmp, 16, 10, tag="k>n_valid"),
              case(dup, q_cmp, 16, 8192, exact=True, tag="duplicated rows"),
              case(emb, q_cmp, TOPK_KMAX, n_valid, tag="k=64"),
              case(emb[:700].contiguous(), q_cmp, k, 700,
                   tag="700-row store"))
    # every row twice, DUP_ODD apart: each value comes an even number of
    # times, so the sorted values pair up bit for bit
    dup = torch.cat([emb[:DUP_ODD], emb[:DUP_ODD]]).contiguous()
    vals, idx = topk_retrieval_cuda(dup, q_cmp, 16, 2 * DUP_ODD)
    err = max(err, case(dup, q_cmp, 16, 2 * DUP_ODD, out=(vals, idx),
                        tag=f"duplicated rows {DUP_ODD} apart"))
    pairs = bool(torch.equal(vals[:, 0::2], vals[:, 1::2]))
    say(f"top-k duplicated rows {DUP_ODD} apart: sorted values equal in "
        f"pairs {pairs}")
    check(pairs, "top-k: identical rows gave different values")
    del dup
    k_refused(lambda kk: topk_retrieval_cuda(emb, q_cmp, kk, n_valid),
              "top-k", check)

    # the main path: the entry point a user calls, at the full route batch
    torch.cuda.synchronize()
    tr_ops.topk_launches = 0
    vals, idx = tr_ops.topk_retrieval(emb, q_route, k, n_valid)
    launches = tr_ops.topk_launches
    torch.cuda.synchronize()
    check(launches >= 1, "top-k: the kernel was not launched")
    vv, vi, _ = retrieval_vote_cuda(emb, labels, q_route, k, n_valid)
    same = bool(torch.equal(vals, vv) and torch.equal(idx, vi))
    ordered = bool((vals[:, :-1] >= vals[:, 1:]).all())
    say(f"top-k entry point (B={N_ROUTE}, N_db={n_valid}, k={k}): "
        f"{launches} launch; (vals, idx) bit-identical to the vote entry "
        f"point's: {same}; vals finite {bool(torch.isfinite(vals).all())}, "
        f"descending {ordered}, idx in range "
        f"{bool(((idx >= 0) & (idx < n_valid)).all())}")
    check(same, "top-k and vote entry points differ")
    check(vals.shape == (N_ROUTE, k) and bool(torch.isfinite(vals).all())
          and ordered and bool(((idx >= 0) & (idx < n_valid)).all()),
          "top-k output shape, finiteness, order or range")
    # every row of the main path's output against the plain version
    err = max(err, case(emb, q_route, k, n_valid, tag="main path, all rows",
                        out=(vals, idx)))
    del vv, vi

    ms = time_ms(torch, lambda: topk_retrieval_cuda(emb, q_route, k,
                                                    n_valid), REPS)
    plain_ms = time_ms(torch, lambda: topk_retrieval_ref(emb, q_route, k,
                                                         n_valid), 3, warm=1)
    store_t = emb[:n_valid].T
    lib_ms = time_ms(torch, lambda: torch.matmul(q_route, store_t), REPS)
    two_ms = time_ms(torch, lambda: torch.topk(torch.matmul(q_route, store_t),
                                               k, dim=1), REPS)
    q_win = q_route[:N_WINDOW]
    two_win = time_ms(torch, lambda: torch.topk(torch.matmul(q_win, store_t),
                                                k, dim=1), REPS)
    del store_t
    d = emb.shape[1]
    say(f"top-k: two calls torch.matmul + torch.topk {two_ms:.3f} ms at "
        f"B={N_ROUTE}, {two_win:.3f} ms at B={N_WINDOW}")
    row = retrieval_row("topk_retrieval",
                        "src/repro/kernels/topk_retrieval/kernel.py:141",
                        launches, err, N_ROUTE, n_valid, d, k, 0, ms,
                        plain_ms, lib_ms, say, "top-k")
    row.update(window_timing(
        torch, say, time_ms, lambda q: topk_retrieval_cuda(emb, q, k, n_valid),
        q_route, emb, n_valid, d, k, 0, "top-k"))
    row.update(matmul_topk_ms=two_ms, window_matmul_topk_ms=two_win,
               equal_to_vote=same)
    return row


def device_kernels(torch, fn):
    """The names of the device kernels one ``fn()`` enqueues, from
    ``analysis.profiler`` (after one warm-up call), a name once a launch."""
    from repro_torch.analysis import profiler
    fn()
    torch.cuda.synchronize()
    prof = profiler.profile(fn)
    return [name for name, (_, n) in prof.kernels.items() for _ in range(n)]


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """The host's µs per ``fn()``: ``calls`` calls enqueued back to back
    with no synchronisation between them, so a wrapper whose host work
    outlasts its kernel is timed by that work alone."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6


def launch_floor_ms(torch, dev) -> float:
    """One launch's floor on the device: ``zero_()`` of a one-element
    tensor, replayed from a CUDA graph of GRAPH_CALLS calls."""
    t = torch.zeros(1, device=dev)
    return graph_ms(torch, t.zero_)


def step_timing(torch, step, c, a, lam1, lam2):
    """The assign step's times at (c, a, λ1, λ2): ms a call with the
    wrapper (CUDA events), the wrapper's host µs, ms on the device
    (``graph_ms``), the launch floor, and the device kernels one call
    enqueues."""
    def fn():
        return step(c, a, lam1, lam2)
    return dict(ms=time_ms(torch, fn, 50), host_us=host_us(torch, fn),
                graph_ms=graph_ms(torch, fn),
                floor_ms=launch_floor_ms(torch, c.device),
                device_kernels=device_kernels(torch, fn))


def assign_step_phase(torch, say, check, time_ms, dev, cost, cap, lam1,
                      lam2):
    """3d: the assign-step kernel against its plain version at the route
    batch's predictions with 3b's multipliers, at N 1,000, at M 16 and with
    a duplicated column, two calls in a row, three replays of one captured
    call, the fast path against the slow one; M 17 is refused.  Then its
    times: with the wrapper, the wrapper's host work, on the device, the
    launch floor, and the device kernels one step enqueues (1).  Returns the
    kernels-line row (launches are filled in by 3e, the kernel's main
    path)."""
    from repro_torch.kernels.lagrangian_assign import kernel as la_kernel
    from repro_torch.kernels.lagrangian_assign.ref import assign_step_ref
    from repro_torch.analysis import kernel_work, roofline
    assign_step_cuda = la_kernel.assign_step_cuda

    def hold(got, c, a, l1, l2, tag, tie=None):
        x, cnt, qs, cs = got
        rx, rcnt, rq, rc = assign_step_ref(c, a, l1, l2, c.shape[0])
        same_x = bool(torch.equal(x, rx))
        same_cnt = bool(torch.equal(cnt, rcnt))
        same_sums = bool(torch.equal(qs, rq) and torch.equal(cs, rc))
        err = max(abs(float(qs) - float(rq)), abs(float(cs) - float(rc)))
        say(f"assign step {tag}: N={c.shape[0]} M={c.shape[1]} | x equal "
            f"{same_x}, counts equal {same_cnt} ({cnt.int().tolist()}), "
            f"qsum/csum bit-identical {same_sums} ({float(qs):.6g}, "
            f"{float(cs):.6g})")
        check(same_x, f"assign step {tag}: x")
        check(same_cnt and int(cnt.sum()) == c.shape[0],
              f"assign step {tag}: counts")
        check(same_sums, f"assign step {tag}: qsum/csum")
        if tie is not None:
            check(bool((x != tie).all()),
                  f"assign step {tag}: a tie went to the higher index")
        return err

    def case(c, a, l1, l2, tag, tie=None):
        got = assign_step_cuda(c, a, l1, l2)
        torch.cuda.synchronize()
        return hold(got, c, a, l1, l2, tag, tie)

    gen = torch.Generator(device=dev).manual_seed(13)
    c16 = torch.rand(N_ROUTE, STEP_M, generator=gen, device=dev)
    a16 = torch.rand(N_ROUTE, STEP_M, generator=gen, device=dev)
    l16 = torch.rand(STEP_M, generator=gen, device=dev) * 0.1
    c6, a6 = c16[:, :6].clone(), a16[:, :6].clone()
    c6[:, 3], a6[:, 3] = c6[:, 1], a6[:, 1]
    l6 = l16[:6].clone()
    l6[3] = l6[1]
    l6[[0, 2, 4]] += 0.3          # so that columns 1 and 3 win often
    lam_r = torch.tensor(2.5, device=dev)
    check(la_kernel._fast_ok(cost, cap, lam1, lam2),
          "assign step: the route batch does not take the fast path")
    err = max(case(cost, cap, lam1, lam2, "route batch, 3b's multipliers"),
              case(cost[:STEP_N], cap[:STEP_N], lam1, lam2, "N=1,000"),
              case(c16, a16, lam_r, l16, "M=16"),
              case(c6, a6, lam_r, l6, "duplicated column", tie=3))
    # two calls in a row, no synchronisation between them: the second
    # finds the ticket counter the first left at 0
    first = assign_step_cuda(cost, cap, lam1, lam2)
    second = assign_step_cuda(cost, cap, lam_r, lam2 * 0.5)
    torch.cuda.synchronize()
    err = max(err, hold(first, cost, cap, lam1, lam2, "first of two"),
              hold(second, cost, cap, lam_r, lam2 * 0.5, "second of two"))
    # one call captured into a CUDA graph and replayed three times, its
    # outputs overwritten before each replay
    graph, outs = captured_call(
        torch, lambda: assign_step_cuda(cost, cap, lam1, lam2))
    for i in range(3):
        outs[0].fill_(-1)
        for t in outs[1:]:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        err = max(err, hold(outs, cost, cap, lam1, lam2,
                            f"graph replay {i + 1} of 3"))
    tickets = [int(v[3].item()) for v in la_kernel._step_scratch.values()]
    say(f"assign step scratch: {len(tickets)} (device, stream, shape) "
        f"entries, ticket counters after every launch {tickets}")
    check(all(t == 0 for t in tickets),
          "assign step: a ticket counter was not reset")
    # the slow path (a strided cost, a Python-number λ1, a float64 λ2)
    # against the fast path on the same values
    cost_t = cost.t().contiguous().t()
    slow_args = (cost_t, cap, float(lam1), lam2.double())
    check(not la_kernel._fast_ok(*slow_args),
          "assign step: the slow path's arguments took the fast path")
    fast = assign_step_cuda(cost, cap, lam1, lam2)
    slow = assign_step_cuda(*slow_args)
    torch.cuda.synchronize()
    same_paths = all(bool(torch.equal(f, g)) for f, g in zip(fast, slow))
    say(f"assign step fast path == slow path (strided cost, float lam1, "
        f"float64 lam2): {same_paths}")
    check(same_paths, "assign step: the fast and slow paths differ")
    try:
        assign_step_cuda(torch.rand(64, STEP_M + 1, device=dev),
                         torch.rand(64, STEP_M + 1, device=dev), lam_r,
                         torch.zeros(STEP_M + 1, device=dev))
        refused = False
    except ValueError:
        refused = True
    check(refused, f"assign step M={STEP_M + 1} was not refused")

    n, m = cost.shape
    tm = step_timing(torch, assign_step_cuda, cost, cap, lam1, lam2)
    p_ms = time_ms(torch, lambda: assign_step_ref(cost, cap, lam1, lam2, n),
                   10)
    nbytes, nops = kernel_work.assign_step(n, m)
    bound = roofline.bound_ms(nops, nbytes)
    share = max(bound, tm["floor_ms"]) / tm["graph_ms"]
    names = tm.pop("device_kernels")
    say(f"assign step: device kernels one step enqueues (torch.profiler): "
        f"{len(names)} {names}")
    check(len(names) == 1 and "assign_step_kernel" in names[0],
          "assign step: one step enqueued other than one kernel")
    say(f"assign step kernel (N={n}, M={m}): {tm['ms'] * 1e3:.2f} us per "
        f"call with its wrapper (one launch; the last CTA sums the blocks "
        f"in order), host {tm['host_us']:.2f} us per call (enqueue time over "
        f"{HOST_CALLS} calls), {tm['graph_ms'] * 1e3:.3f} us on the device "
        f"(replayed from a CUDA graph of {GRAPH_CALLS} calls); launch floor "
        f"{tm['floor_ms'] * 1e3:.3f} us (zero_ of one element, same "
        f"graph), bound {bound * 1e3:.3f} us = max({nbytes / 1e3:.1f} KB / "
        f"3.35 TB/s, {nops / 1e6:.3f} MFLOP / 67 TFLOP/s); max(bound, "
        f"floor) / device = {share:.3f}; plain {p_ms * 1e3:.1f} us; "
        f"library: none (no single PyTorch call)")
    return dict(name="assign_step", route="cuda",
                source="src/repro_torch/csrc/shard_stats.cu",
                replaces="src/repro/kernels/lagrangian_assign/kernel.py:428",
                max_abs_err=err, plain_ms=p_ms, bound_ms=bound,
                bound_by=roofline.bound_by(nops, nbytes), library_ms=None,
                **tm)


def seed_loop(torch, step, c, a, alpha, loads, iters):
    """The seed's per-iteration dual solve (``benchmarks/bench_routing.py``
    ``_seed_per_iteration_launch``): one assign step per iteration and one
    final step, the multipliers updated by tensor ops, so nothing is read
    on the host.  Returns (x, λ1, λ2, found)."""
    import math
    n, m = c.shape
    dev = c.device
    n_t = torch.full((), float(n), device=dev)
    lam1 = torch.zeros((), device=dev)
    lam2 = torch.zeros(m, device=dev)
    best_cost = torch.full((), float("inf"), device=dev)
    best_x = torch.zeros(n, dtype=torch.int32, device=dev)
    found = torch.zeros((), dtype=torch.bool, device=dev)
    for t in range(iters):
        x, counts, qsum, csum = step(c, a, lam1, lam2)
        q = qsum / n_t
        feasible = (q >= alpha) & torch.all(counts <= loads)
        better = feasible & (csum < best_cost)
        best_cost = torch.where(better, csum, best_cost)
        best_x = torch.where(better, x, best_x)
        found = found | feasible
        lr = 1.0 / math.sqrt(1.0 + t)
        lam1 = torch.clamp(lam1 + 4.0 * n * lr * (alpha - q), min=0.0)
        lam2 = torch.clamp(lam2 + 0.5 * lr * (counts - loads), min=0.0)
    x_last = step(c, a, lam1, lam2)[0]
    return torch.where(found, best_x, x_last), lam1, lam2, found


def seed_inputs(torch, dev):
    """3e's problem: uniform cost and quality from a seeded generator on
    ``dev``, loads N/2; the arguments of ``seed_loop`` after ``step``."""
    gen = torch.Generator(device=dev).manual_seed(17)
    c = torch.rand(SEED_N, SEED_M, generator=gen, device=dev)
    a = torch.rand(SEED_N, SEED_M, generator=gen, device=dev)
    loads = torch.full((SEED_M,), SEED_N / 2.0, device=dev)
    return c, a, SEED_ALPHA, loads, SEED_ITERS


def same_solve(u, v) -> bool:
    """Two seed-loop results (x, λ1, λ2, found) equal bit for bit."""
    return all(p.cpu().equal(q.cpu()) for p, q in zip(u, v))


def seed_loop_phase(torch, say, check, time_ms, dev):
    """3e: the seed's per-iteration structure on the card (151 assign-step
    launches a solve, no host read: run under the sync debug mode "error"),
    the same solve captured once into a CUDA graph (151 launches at the
    capture) and replayed, the same loop on the CPU's plain version (all
    three equal bit for bit), the fused one-launch solve on the same
    inputs, and the legacy and sweep entry points on the card.  Returns the
    assign step's main-path launches and the three solves' ms."""
    from repro_torch.core import DualSolver, solve_assignment, solve_budget
    from repro_torch.kernels.lagrangian_assign import ops as la_ops

    args = seed_inputs(torch, dev)
    c, a, _, loads, _ = args
    # the main path of the assign step: one seed solve, counted
    torch.cuda.synchronize()
    la_ops.step_launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = seed_loop(torch, la_ops.assign_step, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = la_ops.step_launches
    torch.cuda.synchronize()
    check(launches == SEED_ITERS + 1,
          f"seed loop: {launches} assign-step launches, expected "
          f"{SEED_ITERS + 1}")
    x, lam1, lam2, found = eager
    cpu = seed_loop(torch, la_ops.assign_step, c.cpu(), a.cpu(), SEED_ALPHA,
                    loads.cpu(), SEED_ITERS)
    same = same_solve(eager, cpu)
    # the same solve as one captured program (JAX runs it under jit)
    la_ops.step_launches = 0
    graph, captured = captured_call(
        torch, lambda: seed_loop(torch, la_ops.assign_step, *args))
    # the warm-up solve on the capture's stream launches first
    captured_launches = la_ops.step_launches - (SEED_ITERS + 1)
    for t in captured:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    same_graph = same_solve(captured, eager)
    xi = x.long()
    q_mean = float(a.gather(1, xi[:, None]).mean())
    dollars = float(c.gather(1, xi[:, None]).sum())
    counts = torch.bincount(xi, minlength=SEED_M)
    say(f"seed loop (N={SEED_N}, M={SEED_M}, alpha {SEED_ALPHA}, loads "
        f"N/2, {SEED_ITERS} iterations): {launches} assign-step launches "
        f"under sync debug mode 'error' (no host read); card = CPU plain "
        f"loop bit for bit (x, lam1, lam2, found): {same}; captured once "
        f"into a CUDA graph ({captured_launches} launches at the capture) "
        f"and replayed = eager bit for bit: {same_graph}; found "
        f"{bool(found)}, lam1 {float(lam1):.6g}, mean quality "
        f"{q_mean:.4f}, cost {dollars:.2f}, counts {counts.tolist()}")
    check(same, "seed loop: card and CPU differ")
    check(captured_launches == SEED_ITERS + 1,
          f"seed loop: {captured_launches} launches at the capture")
    check(same_graph, "seed loop: the captured solve differs from eager")
    check(bool(found) and q_mean >= SEED_ALPHA
          and bool((counts <= loads.long()).all()),
          "seed loop: no feasible assignment")

    # the fused one-launch solve on the same inputs, and the legacy and
    # sweep entry points on the card (all through the fused kernel)
    xk, ik = la_ops.solve_assignment_kernel(c, a, SEED_ALPHA, loads)
    xs, isv = solve_assignment(c, a, SEED_ALPHA, loads)
    check(bool(torch.equal(xk, xs)) and int(ik.iters_run) == SEED_ITERS,
          "solve_assignment_kernel differs from solve_assignment")
    xb, ib = solve_budget(c, a, float(c.min(1).values.sum()) * 1.5, loads)
    check(xb.shape == (SEED_N,) and bool(ib.feasible),
          "solve_budget: no feasible assignment")
    alphas = torch.tensor([0.6, 0.7, 0.8], device=dev)
    solver = DualSolver()
    xg, ig = solver.solve_grid(c, a, alphas, loads)
    per_loads = torch.stack([loads, loads * 0.8, loads * 0.6])
    xbt, ibt = solver.solve_batch(torch.stack([c, c, a]),
                                  torch.stack([a, a, c]), alphas, per_loads)
    grid_same = batch_same = True
    for j in range(3):
        x1, i1 = solver.solve(c, a, alphas[j], loads)
        grid_same &= bool(torch.equal(xg[j], x1)) and all(
            bool(torch.equal(f[j], g)) for f, g in zip(ig, i1))
        cb, ab = (a, c) if j == 2 else (c, a)
        x2, i2 = solver.solve(cb, ab, alphas[j], per_loads[j])
        batch_same &= bool(torch.equal(xbt[j], x2)) and all(
            bool(torch.equal(f[j], g)) for f, g in zip(ibt, i2))
    say(f"legacy entry points on the card: solve_assignment_kernel == "
        f"solve_assignment, iters {int(ik.iters_run)}, mean quality "
        f"{float(ik.quality):.4f}, cost {float(ik.cost):.2f}; solve_budget "
        f"feasible {bool(ib.feasible)}; solve_grid (alpha 0.6/0.7/0.8) "
        f"elements == solve: {grid_same}, qualities "
        f"{[round(float(v), 4) for v in ig.quality]}; solve_batch with "
        f"(B, M) loads elements == solve: {batch_same}")
    check(grid_same, "solve_grid: an element differs from solve")
    check(batch_same, "solve_batch: an element differs from solve")
    check(bool((ig.quality[1:] >= ig.quality[:-1] - 1e-6).all()),
          "solve_grid: quality not monotone in alpha")

    tm = seed_timing(torch, la_ops.assign_step, args, graph,
                     lambda: la_ops.solve_assignment_kernel(
                         c, a, SEED_ALPHA, loads))
    say(f"seed loop timing: eager {tm['seed_loop_ms']:.3f} ms per solve "
        f"({SEED_ITERS + 1} assign-step launches + ~17 tensor ops per "
        f"iteration from Python, "
        f"{tm['seed_loop_ms'] * 1e3 / (SEED_ITERS + 1):.1f} us per "
        f"iteration), captured {tm['seed_graph_ms']:.3f} ms per replay "
        f"({tm['seed_graph_ms'] * 1e3 / (SEED_ITERS + 1):.2f} us per "
        f"iteration), against the fused one-launch solve "
        f"{tm['fused_solve_ms']:.3f} ms (eager "
        f"{tm['seed_loop_ms'] / tm['fused_solve_ms']:.2f}x, captured "
        f"{tm['seed_graph_ms'] / tm['fused_solve_ms']:.2f}x)")
    return launches, tm


def seed_timing(torch, step, args, graph, fused):
    """ms a seed-loop solve eager (``step`` from Python), as one replay of
    its captured ``graph``, and of the ``fused`` one-launch solve."""
    return dict(
        seed_loop_ms=time_ms(torch, lambda: seed_loop(torch, step, *args),
                             SEED_REPS, warm=1),
        seed_graph_ms=time_ms(torch, graph.replay, SEED_REPS, warm=1),
        fused_solve_ms=time_ms(torch, fused, REPS))


DUAL_BIG = (131_072, 16)   # 3b: a problem whose rows do not fit shared memory
SMEM_BYTES_PER_CLOCK = 128  # an SM's shared-memory bandwidth (32 banks x 4 B)


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def dual_solve_phase(torch, say, check, time_ms, dev, cost, cap, budget):
    """3b: the cluster dual-solve kernel against its plain version on the
    route batch's predictions (quality and budget; cold, cold with the
    stall exit, warm), on two problems whose rows do not fit shared memory
    (a dyadic grid and continuous random data) and on the two launches that
    time the fixed cost (one row per CTA; a few rows in one block, so that
    most CTAs own none); its time at N 16,384, 4,096 and one row per CTA,
    and its design bound.  Returns the kernels-line row and the solved
    cases."""
    from repro_torch.kernels.lagrangian_assign import kernel as la_kernel
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.lagrangian_assign.kernel import (
        blocked_dual_ascent_cuda, dual_solve_cuda)
    from repro_torch.kernels.lagrangian_assign.ref import (
        blocked_dual_ascent_ref, fused_dual_solve_ref)
    from repro_torch.analysis import kernel_work, roofline

    n, m = cost.shape
    loads = torch.full((m,), float(int(0.3 * n)), device=dev)
    lam_err = 0.0

    def compare(tag, p, iters):
        nonlocal lam_err
        out_k = dual_solve_cuda(*p.args, iters=iters, patience=3)
        chosen = la_kernel.cluster
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
        say(f"dual solve {tag}: N={p.a_mat.shape[0]} M={p.a_mat.shape[1]} "
            f"| cluster {chosen[0]} CTAs, rows in shared memory {chosen[1]}"
            f" | x equal {same_x}, iters_run {it_k}/{it_r}, lam {lam_k:.6g}/"
            f"{lam_r:.6g} (rel {rel:.2g}, lam2 rel {rel2:.2g}), "
            f"feasible {bool(ik.feasible)}")
        check(chosen[0] > 1, f"dual solve {tag}: a cluster of one CTA")
        check(same_x, f"dual solve {tag}: x")
        check(it_k == it_r, f"dual solve {tag}: iters_run")
        check(rel <= 1e-3 and rel2 <= 1e-3, f"dual solve {tag}: lambda")
        return out_k, out_r, chosen, it_k

    def x_of(out, a, b):
        """The assignment the packed output names (``ops.finish``'s argmin
        on the unified problem)."""
        mm = a.shape[1]
        found = out[3] > 0.0
        lam = torch.where(found, out[1], out[0])
        lam2 = torch.where(found, out[8 + mm:8 + 2 * mm], out[8:8 + mm])
        return torch.argmin(a + lam * b + lam2[None, :], dim=1)

    def x_of_lam(out):
        """The multiplier the packed output's assignment is taken at."""
        return out[1] if out[3] > 0.0 else out[0]

    def held(tag, out_k, args, iters, nv=None, x_exact=True):
        """``out_k`` (one launch on ``args``) against the blocked plain
        version bit for bit (over ``nv``, else one shard of every row), and
        against the fused plain version by the x / iters_run / lambda
        contract; without ``x_exact`` the rows whose x differs are counted,
        beside a float64 trajectory's, and not required to be 0."""
        a, b = args[0], args[1]
        rest = args[3:] if nv is not None else args[2:]
        nv = nv if nv is not None else torch.tensor([float(a.shape[0])],
                                                    device=dev)
        out_b, _ = blocked_dual_ascent_ref(a, b, nv, *rest, iters=iters,
                                           patience=3)
        out_r = fused_dual_solve_ref(a, b, *rest, iters=iters, patience=3)
        same_b = bool(torch.equal(out_k, out_b))
        x_diff = int((x_of(out_k, a, b) != x_of(out_r, a, b)).sum())
        it_k, it_r = int(out_k[6]), int(out_r[6])
        rel = float(((out_k[[0, 1]] - out_r[[0, 1]]).abs()
                     / (1.0 + out_r[[0, 1]].abs())).max())
        rel2 = float(((out_k[8:] - out_r[8:]).abs()
                      / (1.0 + out_r[8:].abs())).max())
        say(f"dual solve {tag}: N={a.shape[0]} M={a.shape[1]}, "
            f"{nv.numel()} shards | kernel = blocked plain version bit for "
            f"bit {same_b}; fused plain version: x differs in {x_diff} rows,"
            f" iters_run {it_k}/{it_r}, lam rel {rel:.2g}, lam2 rel "
            f"{rel2:.2g}")
        check(same_b, f"dual solve {tag}: kernel != its order's plain "
              "version")
        check(it_k == it_r, f"dual solve {tag}: iters_run differs from "
              "the fused plain version")
        check(x_diff == 0 or not x_exact, f"dual solve {tag}: x differs "
              "from the fused plain version")
        check(rel <= 1e-3 and rel2 <= 1e-3, f"dual solve {tag}: lambda")
        if not x_exact:
            # which float32 order lands nearer exact sums: the fused plain
            # version with float64 A and B (so float64 sums and lambda)
            a64, b64 = a.double(), b.double()
            out_64 = fused_dual_solve_ref(a64, b64, *rest, iters=iters,
                                          patience=3)
            x64 = x_of(out_64, a64, b64)
            lam64 = float(x_of_lam(out_64))
            say(f"dual solve {tag}: float64 sums give lam {lam64:.9g} "
                f"(iters_run {int(out_64[6])}); off by: kernel "
                f"{abs(float(x_of_lam(out_k)) - lam64):.4g}, fused plain "
                f"{abs(float(x_of_lam(out_r)) - lam64):.4g}; x differs "
                f"from its x in {int((x_of(out_k, a, b) != x64).sum())} "
                f"rows (kernel), {int((x_of(out_r, a, b) != x64).sum())} "
                "(fused plain)")

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
            _, _, chosen, it_k = compare(f"{mode} {case}", p, iters)
            check(chosen[1], f"dual solve {mode} {case}: N={n} rows should "
                  "sit in shared memory")
            solve_cases[(mode, case)] = (p, iters, it_k)

    # beyond shared memory: random costs and qualities on a dyadic grid
    # (torch.randint), so every float32 sum is exact in any order and the
    # kernel and the fused plain version (Tensor.sum) walk one trajectory
    # bit for bit; also held bit for bit to the blocked plain version over
    # one shard, the kernel's own order
    big_n, big_m = DUAL_BIG
    gen = torch.Generator(device=dev).manual_seed(23)
    b_cost = torch.randint(1, 65, (big_n, big_m), generator=gen,
                           device=dev).float() * 2.0 ** -16
    b_qual = torch.randint(0, 17, (big_n, big_m), generator=gen,
                           device=dev).float() / 16.0
    p_big = la_ops.prepare_problem(
        b_cost, b_qual, 0.9, torch.full((big_m,), float(big_n // 12),
                                        device=dev),
        mode="quality", lr_con=4.0, lr_load=0.5)
    out_k, out_r, chosen, _ = compare("beyond shared memory", p_big, 150)
    check(not chosen[1], f"dual solve N={big_n} M={big_m}: the rows should "
          "not fit shared memory")
    out_b, _ = blocked_dual_ascent_ref(
        p_big.a_mat, p_big.b_mat, torch.tensor([float(big_n)], device=dev),
        *p_big.args[2:], iters=150, patience=3)
    same_blocked = bool(torch.equal(out_k, out_b))
    same_fused = bool(torch.equal(out_k[:2], out_r[:2])
                      and torch.equal(out_k[8:], out_r[8:]))
    say(f"dual solve beyond shared memory: kernel = blocked plain version "
        f"(one shard) bit for bit {same_blocked}; lam, lam_best, lam2 = the "
        f"fused plain version's bit for bit {same_fused}")
    check(same_blocked, "dual solve beyond shared memory: kernel != its "
          "order's plain version")
    check(same_fused, "dual solve beyond shared memory: exact sums, yet "
          "the multipliers differ from the fused plain version")
    del b_cost, b_qual, p_big
    # beyond shared memory on continuous random data: sums that round, so
    # a fault in the L2 path's order shows against the blocked plain
    # version.  The fused plain version sums with Tensor.sum in an order
    # of its own: its lambda drifts from the kernel's by float32 rounding,
    # and on 131,072 continuous rows a few sit within that drift of a tie,
    # so there the rows whose x differs are counted, not required to be 0
    c_cost = torch.rand(big_n, big_m, generator=gen, device=dev) * 1e-3
    c_qual = torch.rand(big_n, big_m, generator=gen, device=dev)
    p_cont = la_ops.prepare_problem(
        c_cost, c_qual, 0.9, torch.full((big_m,), float(big_n // 12),
                                        device=dev),
        mode="quality", lr_con=4.0, lr_load=0.5)
    out_k = dual_solve_cuda(*p_cont.args, iters=150, patience=3)
    check(not la_kernel.cluster[1], f"dual solve N={big_n} M={big_m} "
          "continuous: the rows should not fit shared memory")
    held("beyond shared memory, continuous", out_k, p_cont.args, 150,
         x_exact=False)
    del c_cost, c_qual, p_cont

    p, iters, it_run = solve_cases[("quality", "cold")]
    d_ms = time_ms(torch, lambda: dual_solve_cuda(*p.args, iters=iters,
                                                  patience=3), REPS)
    c_size, in_smem = la_kernel.cluster
    d_plain = time_ms(torch, lambda: fused_dual_solve_ref(
        *p.args, iters=iters, patience=3), 5, warm=1)
    pw, iters_w, it_w = solve_cases[("quality", "warm")]
    d_warm = time_ms(torch, lambda: dual_solve_cuda(*pw.args, iters=iters_w,
                                                    patience=3), REPS)
    n4 = 4_096
    args_4k = (p.a_mat[:n4].contiguous(), p.b_mat[:n4].contiguous(),
               *p.args[2:])
    d_4k = time_ms(torch, lambda: dual_solve_cuda(*args_4k, iters=iters,
                                                  patience=3), REPS)
    # the fixed cost of an iteration (barrier, gather, in-order sums,
    # bookkeeping) with no rows to speak of (stall_tol 0, so every
    # iteration runs): one row per CTA (c_size one-row shards through the
    # blocked entry point, so c_size blocks to gather and c_size shard
    # sums) and c_size rows in one block of one shard; the smaller is the
    # fixed cost of the design bound
    args_1 = (p.a_mat[:c_size].contiguous(), p.b_mat[:c_size].contiguous(),
              torch.ones(c_size, device=dev), *p.args[2:])
    held(f"one row per CTA ({c_size} one-row shards)",
         blocked_dual_ascent_cuda(*args_1, iters=iters, patience=3), args_1,
         iters, nv=args_1[2])
    check(la_kernel.cluster[0] == c_size, "dual solve: the one-row-per-CTA "
          "launch took another cluster size")
    row_ms = time_ms(torch, lambda: blocked_dual_ascent_cuda(
        *args_1, iters=iters, patience=3), REPS)
    args_b = (p.a_mat[:c_size].contiguous(), p.b_mat[:c_size].contiguous(),
              *p.args[2:])
    held(f"{c_size} rows in one block ({c_size - 1} CTAs own none)",
         dual_solve_cuda(*args_b, iters=iters, patience=3), args_b, iters)
    block_ms = time_ms(torch, lambda: dual_solve_cuda(
        *args_b, iters=iters, patience=3), REPS)
    fixed_ms = min(row_ms, block_ms)
    t_fixed = fixed_ms * 1e-3 / iters                       # s / iteration
    smem_rate = SMEM_BYTES_PER_CLOCK * sm_clock_hz()        # bytes/s, one SM
    ab_bytes = 4 * n * 2 * m
    d_design = it_run * (t_fixed + ab_bytes / (c_size * smem_rate)) * 1e3
    d_bytes, d_ops = kernel_work.dual_solve(n, m, it_run)
    d_bound = roofline.bound_ms(d_ops, d_bytes)
    say(f"dual solve timing (quality, cold, M={m}, {it_run} iterations; a "
        f"cluster of {c_size} CTAs, rows in shared memory {in_smem}): "
        f"N={n} kernel {d_ms:.4f} ms ({d_ms * 1e3 / max(it_run, 1):.3f} "
        f"us/iteration), N={n4} {d_4k:.4f} ms, one row per CTA "
        f"({c_size} one-row shards) {row_ms:.4f} ms "
        f"({row_ms * 1e3 / iters:.3f} us/iteration), {c_size} rows in one "
        f"block {block_ms:.4f} ms ({block_ms * 1e3 / iters:.3f} "
        f"us/iteration); plain {d_plain:.3f} ms; warm ({it_w} iterations) "
        f"kernel {d_warm:.4f} ms")
    say(f"dual solve design bound: {d_design:.4f} ms = {it_run} x "
        f"({t_fixed * 1e6:.3f} us fixed + {ab_bytes / 1e3:.0f} KB / "
        f"({c_size} SMs x {smem_rate / 1e9:.1f} GB/s shared memory)); "
        f"kernel at {d_design / d_ms:.1%} of it; whole-card floor "
        f"{d_bound * 1e3:.2f} us = max({d_bytes / 1e3:.0f} KB / 3.35 TB/s, "
        f"{d_ops / 1e6:.1f} MFLOP [iters x N x (4M+1)] / 67 TFLOP/s)")
    row = dict(
        name="dual_solve", route="cuda",
        source="src/repro_torch/csrc/dual_solve.cu",
        replaces="src/repro/kernels/lagrangian_assign/kernel.py:251",
        max_abs_err=lam_err, ms=d_ms, plain_ms=d_plain, bound_ms=d_bound,
        bound_by=roofline.bound_by(d_ops, d_bytes), library_ms=None,
        design_bound_ms=d_design,
        cluster=c_size, rows_in_shared_memory=in_smem, ms_n4096=d_4k,
        ms_one_row_per_cta=row_ms, ms_one_block=block_ms,
        fixed_us_per_iteration=t_fixed * 1e6)
    return row, solve_cases


# -- phase T: the predictors fit on the card ---------------------------------

T_STEPS, T_BATCH = 150, 64   # benchmarks/common.py: ECCOS-T and ECCOS-H fits
S3COST_STEPS = 100           # benchmarks/common.py: s3_policy
S3COST_BATCH = 48            # S3Cost.prepare's batch
T_LOSS1_REL = 1e-5           # step 1's loss, card against CPU (relative)
# Each eval_accuracy field, card against CPU.  AdamW's normalised step
# amplifies float sum-order differences, so fits that differ only in that
# order end apart: five CPU fits that differed only in PyTorch's thread
# count (1, 2, 3, 4, 6) spread over 0.028 (ECCOS-T) and 0.034 (S3) in
# capability_acc.
T_ACC_BAND = 0.05
TABLE2 = ("BA", "S3", "PO", "ECCOS-T", "ECCOS-R", "ECCOS-H")
FITTED = ("ECCOS-T", "ECCOS-H", "S3")


def table2_predictor(name, train, device):
    """The predictor behind Table 2's policy ``name`` on ``device``, built
    through the port's entry points at ``benchmarks/common.py``'s
    settings, and its fit's per-step losses (None where nothing trains):
    ECCOS-R a k = 8 store, PO a k = 1 store (``PerceptionOnly.prepare``),
    ECCOS-T and ECCOS-H 150 steps of batch 64 from seed 0, S3 100 steps of
    batch 48 (``S3Cost.prepare``); BA has none."""
    from repro_torch.core import (HybridPredictor, PerceptionOnly,
                                  PredictorConfig, RetrievalPredictor,
                                  S3Cost, TrainedPredictor)
    from repro_torch.core import predictor as pmod
    if name == "BA":
        return None, None
    if name == "ECCOS-R":
        return RetrievalPredictor(k=8, device=device).fit(train), None
    if name == "PO":
        return PerceptionOnly(device=device).prepare(train).ret, None
    kept, fit = [], pmod.TrainedPredictor.fit

    def keep(self, *a, **kw):       # S3Cost.prepare drops the losses
        kept.append(fit(self, *a, **kw))
        return kept[-1]
    pmod.TrainedPredictor.fit = keep
    try:
        cfg = PredictorConfig(n_models=train.m, n_buckets=10)
        if name == "S3":
            pred = S3Cost(steps=S3COST_STEPS, device=device).prepare(
                train).pred
        elif name == "ECCOS-T":
            pred = TrainedPredictor(cfg, device=device)
            pred.fit(train, steps=T_STEPS, batch=T_BATCH, seed=0)
        else:
            pred = HybridPredictor(cfg, device=device).fit(
                train, steps=T_STEPS, batch=T_BATCH, seed=0)
    finally:
        pmod.TrainedPredictor.fit = fit
    return pred, kept[0]


def table2_policy(name, pred, rkw):
    """Table 2's policy ``name`` over the predictor ``pred`` (or its
    recording or replay): ``OmniRouter`` for the ECCOS rows, else the
    baseline with ``pred`` in place of the one ``prepare`` builds."""
    from repro_torch.core import (BalanceAware, OmniRouter, PerceptionOnly,
                                  RouterConfig, S3Cost)
    if name == "BA":
        return BalanceAware()
    if name.startswith("ECCOS"):
        return OmniRouter(pred, RouterConfig(**rkw), name=name)
    if name == "S3":
        pol = S3Cost()
        pol.pred = pred
    else:
        pol = PerceptionOnly()
        pol.ret = pred
    return pol


def first_step(name, train, device):
    """Step 1 of ``name``'s fit on ``device``: the loss and the gradient
    leaves at the seed-0 initial tree on the first batch (the batch
    order of ``TrainedPredictor.fit``)."""
    import numpy as np
    import torch
    from repro_torch.common import init_params
    from repro_torch.core.predictor import (PredictorConfig, loss_fn,
                                            predictor_decls)
    from repro_torch.data import tokenizer
    from repro_torch.data.qaserve import bucketize
    from repro_torch.training import tree_leaves
    cfg = PredictorConfig(n_models=train.m, n_buckets=10)
    batch = S3COST_BATCH if name == "S3" else T_BATCH
    params = init_params(predictor_decls(cfg),
                         torch.Generator().manual_seed(0), device)
    flat = tree_leaves(params)
    for t in flat:
        t.requires_grad_(True)
    idx = np.random.RandomState(0).choice(train.n, size=min(batch, train.n),
                                          replace=False)
    loss, _ = loss_fn(cfg, params, {
        "tokens": torch.as_tensor(tokenizer.encode_batch(
            [train.queries[i] for i in idx], cfg.max_len), device=device),
        "correct": torch.as_tensor(train.correct[idx], device=device),
        "len_bucket": torch.as_tensor(
            bucketize(train.out_len[idx], cfg.n_buckets), device=device)})
    grads = torch.autograd.grad(loss, flat)
    return float(loss.detach()), [g.cpu().numpy() for g in grads]


def fit_info(name, pred, losses, train, test, device):
    """What phase T compares of one fit: its losses, the three
    ``eval_accuracy`` fields on the test split and its first step."""
    return dict(losses=losses, acc=pred.eval_accuracy(test),
                first=first_step(name, train, device))


def predictor_fit_phase(torch, np, dev, say, check):
    """T: ECCOS-T, ECCOS-H and S3 fit on the card at
    ``benchmarks/common.py``'s settings, every parameter and optimizer
    state on the card (each AdamW update checks its tensors' devices), in
    full float32 (TF32 off).  Returns {name: (predictor, fit info, ms a
    step)}; the same fits run on the CPU in phase S's worker processes
    and ``predictor_fit_report`` holds the two against each other."""
    from repro_torch.data.qaserve import generate
    from repro_torch.training import optim
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "T: float32 matmuls would run in TF32")
    train, _, test = generate(n=S1_N, seed=0).split()
    seen = dict(calls=0, off=0)
    update = optim.AdamW.update

    def on_card(self, grads, state, params):
        leaves = optim.tree_leaves([grads, state["m"], state["v"], params])
        seen["calls"] += 1
        seen["off"] += sum(t.device.type != "cuda" for t in leaves)
        return update(self, grads, state, params)

    out = {}
    t_phase = time.perf_counter()
    optim.AdamW.update = on_card
    try:
        for name in FITTED:
            seen.update(calls=0, off=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred, losses = table2_predictor(name, train, dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            steps = len(losses)
            info = fit_info(name, pred, losses, train, test, dev)
            say(f"T {name} (card): {steps} steps in {secs:.2f} s"
                + (" (with the store's build)" if name == "ECCOS-H" else "")
                + f", {secs / steps * 1e3:.2f} ms a step; loss "
                f"{losses[0]:.6f} -> {losses[-1]:.6f}; accuracy "
                f"{info['acc']}; AdamW updates {seen['calls']}, tensors off "
                f"the card {seen['off']}")
            check(seen["calls"] == steps and seen["off"] == 0,
                  f"T {name}: an update ran off the card")
            check(bool(np.all(np.isfinite(losses))), f"T {name}: a loss is "
                  "not finite")
            check(np.mean(losses[-10:]) < np.mean(losses[:10]),
                  f"T {name}: the loss did not fall")
            out[name] = (pred, info, secs / steps * 1e3)
    finally:
        optim.AdamW.update = update
    say(f"phase T (card): {time.perf_counter() - t_phase:.1f} s")
    return out


def predictor_fit_report(np, say, check, card, cpu):
    """T's comparison: each card fit against the same fit on the CPU."""
    summary = {}
    for name in FITTED:
        _, c, ms = card[name]
        h = cpu[name]
        lc, lh = np.array(c["losses"]), np.array(h["losses"])
        rel = np.abs(lc - lh) / np.abs(lh)
        (l1c, gc), (l1h, gh) = c["first"], h["first"]
        ggap = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                     1e-30)
                   for a, b in zip(gc, gh))
        acc = {k: (c["acc"][k], h["acc"][k]) for k in h["acc"]}
        say(f"T {name}, card against CPU: step 1 loss {lc[0]:.7f} / "
            f"{lh[0]:.7f} (relative {rel[0]:.3g}; first step alone "
            f"{abs(l1c - l1h) / abs(l1h):.3g}), largest gradient gap "
            f"{ggap:.3g} of a leaf's largest element; largest relative "
            f"loss gap over steps 1-5 {rel[:5].max():.3g}, at step "
            f"{len(lh)} {rel[-1]:.3g}; accuracy card / CPU "
            + ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in
                        acc.items()) + f"; {ms:.2f} ms a step on the card")
        check(len(lc) == len(lh), f"T {name}: step counts differ")
        check(rel[0] <= T_LOSS1_REL, f"T {name}: step 1's loss differs")
        check(all(abs(a - b) <= T_ACC_BAND for a, b in acc.values()),
              f"T {name}: an accuracy differs by more than {T_ACC_BAND}")
        summary[name] = dict(ms_step=ms, loss1_rel=float(rel[0]),
                             loss_rel_max_1_5=float(rel[:5].max()),
                             loss_rel_last=float(rel[-1]), grad_gap=ggap,
                             acc_card=c["acc"], acc_cpu=h["acc"])
    return summary


# -- phase S: the event-driven serving simulator ----------------------------

S1_N = 2_700            # benchmarks/common.py: the paper's pool (Table 7)
S1_STREAM = 108         # benchmarks/common.py: streaming_subset
S1_ALPHA = 0.75         # benchmarks/bench_serving.py: the paper's alpha
S2_N = 1_600            # benchmarks/bench_robust.py at its full size
S2_RATE = 80.0
S2_KAPPA = 0.5
S2_RETRY = 6
S2_FAULTY = (0, 1)      # hard down at t = 1; error rate 0.6 over [0.5, 4)
S3_SECONDS = 60.0       # benchmarks/bench_streaming.py: ~60 s of traffic
S3_WINDOW_ARRIVALS = 64  # benchmarks/bench_streaming.py: WINDOW_ARRIVALS
S3_LOADS = 64           # per model: 384 slots against ~116 in flight
S3_TOKENS_PER_SEC = 600.0
S3_HOLD_EVERY = 16      # S3 holds every 16th window's launches
CPU_WORKERS = 8         # processes for the CPU replays and plain runs


class RecordedPredictor:
    """The device predict contract of ``inner`` (``device``, ``token_len``,
    ``device_inputs``, ``predict_device``; ``observe`` passes through) and
    its ``predict_arrays`` (the S3 and PO baselines' path), keeping every
    call's inputs and predictions, so that the CPU can replay the run
    against the card's predictions."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    @property
    def device(self):
        return self.inner.device

    @property
    def token_len(self):
        return self.inner.token_len

    def device_inputs(self):
        return self.inner.device_inputs()

    def observe(self, texts, correct, out_len):
        return self.inner.observe(texts, correct, out_len)

    def predict_device(self, inputs, tokens, input_len, price_in, price_out):
        out = self.inner.predict_device(inputs, tokens, input_len, price_in,
                                        price_out)
        self.calls.append(tuple(a.clone() for a in (
            tokens, input_len, price_in, price_out, out[0], out[2])))
        return out

    def predict_arrays(self, batch):
        import numpy as np
        out = self.inner.predict_arrays(batch)
        self.calls.append((list(batch.queries), np.asarray(batch.input_len),
                           np.asarray(batch.price_in),
                           np.asarray(batch.price_out), out[0], out[2]))
        return out


class ReplayPredictor:
    """Answers each predict on the CPU with the next recorded call's
    (capability, cost) (NumPy arrays), after checking that the call's
    inputs (tokens, input lengths, prices) are the recorded ones."""

    def __init__(self, calls, token_len):
        import torch
        self.calls, self.token_len = calls, token_len
        self.device = torch.device("cpu")
        self.next = 0

    def device_inputs(self):
        return None

    def observe(self, texts, correct, out_len):
        return self     # the card's store grew; its votes are recorded

    def _take(self, got):
        """The next recorded call's (capability, cost), after checking
        that its inputs are ``got``."""
        import numpy as np
        w = self.next
        if w >= len(self.calls):
            raise RuntimeError("the CPU replay asked for more predictions "
                               "than the card made")
        *want, cap, cost = self.calls[w]
        if not (len(want) == len(got) and all(
                np.array_equal(a, b) for a, b in zip(got, want))):
            raise RuntimeError(f"the CPU replay's window {w} differs from "
                               "the card's in its inputs")
        self.next += 1
        return cap, cost

    def predict_device(self, inputs, tokens, input_len, price_in, price_out):
        import torch
        cap, cost = self._take([a.numpy() for a in (
            tokens, input_len, price_in, price_out)])
        return torch.from_numpy(cap), None, torch.from_numpy(cost)

    def predict_arrays(self, batch):
        import numpy as np
        cap, cost = self._take([
            list(batch.queries), np.asarray(batch.input_len),
            np.asarray(batch.price_in), np.asarray(batch.price_out)])
        return cap, None, cost


def _host(x):
    """A kept call's tensors as NumPy arrays (other values as they are)."""
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x.cpu().numpy() if hasattr(x, "cpu") else x


def _same(a, b) -> bool:
    import numpy as np
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def sim_case(case):
    """(train, served ds, RouterConfig kwargs, SchedulerConfig kwargs,
    Table 2 policy) of one S1 / S2 run, by its name: an S1 name ends in
    its policy, or names none for ECCOS-R."""
    import numpy as np
    from repro_torch.data.qaserve import generate
    if case.startswith("S1"):
        train, _, test = generate(n=S1_N, seed=0).split()
        streaming = case == "S1 streaming"
        ds = test.subset(np.arange(S1_STREAM)) if streaming else test
        cfg = dict(mode="streaming" if streaming else "batching", loads=4,
                   fold_online=case == "S1 batching fold_online")
        last = case.split()[-1]
        return (train, ds, dict(alpha=S1_ALPHA), cfg,
                last if last in TABLE2 else "ECCOS-R")
    from repro_torch.serving import faults
    train, _, test = generate(n=S2_N, seed=3).split(0.5, 0.0, seed=0)
    budget = 3.5 * float(np.delete(test.cost_matrix(), S2_FAULTY,
                                   axis=1).min(1).sum())
    robust = case == "S2 robust"
    cfg = dict(arrival="poisson", arrival_rate=S2_RATE, window=0.25,
               streaming_dual=True, horizon=test.n)
    if case != "S2 healthy":
        plan = faults.FaultPlan(
            {S2_FAULTY[0]: (faults.FaultSpec("hard_down", start=1.0),),
             S2_FAULTY[1]: (faults.FaultSpec("error_rate", rate=0.6,
                                             start=0.5, end=4.0),)}, seed=1)
        cfg.update(fault_plan=plan, retry_budget=S2_RETRY, health=robust)
    return train, test, dict(budget=budget, robust=robust,
                             kappa=S2_KAPPA if robust else 1.0), cfg, \
        "ECCOS-R"


def cpu_sim_job(case, recorded=None, token_len=None, blocked=None):
    """One CPU run of a phase S case (``sim_case``'s five values), in a
    worker process.  With ``recorded`` (the card's predictions, NumPy) it
    replays the card's run and keeps every blocked-ascent call, to hold
    the card's launches to the plain version on the same inputs; without,
    it builds and fits its own predictor on the CPU (phase T's CPU fit,
    whose ``fit_info`` it returns for the trained policies).  Returns (the
    ServeResult, seconds, the blocked calls that differ from the card's or
    None, the fit's info or None)."""
    import torch
    from repro_torch.core import SchedulerConfig, run_serving
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    torch.set_num_threads(1)
    train, ds, rkw, skw, name = case
    fit = None
    if recorded is None:
        pred, losses = table2_predictor(name, train, "cpu")
        if losses is not None:
            fit = fit_info(name, pred, losses, train, ds, "cpu")
    else:
        pred = ReplayPredictor(recorded, token_len)
    kept = KeptCalls(la_ops, "blocked_dual_ascent")
    kept.on = True
    t0 = time.perf_counter()
    try:
        res = run_serving(ds, table2_policy(name, pred, rkw),
                          SchedulerConfig(**skw))
    finally:
        kept.restore()
    seconds = time.perf_counter() - t0
    if recorded is None:
        return res, seconds, None, fit
    if pred.next != len(recorded):
        raise RuntimeError("the CPU replay made fewer predictions than the "
                           "card")
    # the blocked plain version on the card's launches' inputs: the replay
    # makes the same calls, so its outputs are the plain version's
    ours = [(_host(a), _host(kw), _host(out[0])) for a, kw, out in kept.calls]
    bad = ([i for i, (c, p) in enumerate(zip(blocked, ours))
            if not (_same(c[0], p[0]) and _same(c[1], p[1]))
            or not _same(c[2], p[2])]
           if len(blocked) == len(ours) else ["count"])
    return res, seconds, bad, None


def result_diff(a, b):
    """The ``ServeResult`` fields, all but the wall time, that differ."""
    import dataclasses
    import numpy as np
    return [f.name for f in dataclasses.fields(a)
            if f.name != "scheduling_seconds"
            and not np.array_equal(np.asarray(getattr(a, f.name)),
                                   np.asarray(getattr(b, f.name)))]


def result_line(res):
    return (f"SR {res.success_rate:.6f}, $ {res.cost:.6f}, makespan "
            f"{res.makespan:.3f} s, counts {res.per_model_counts.tolist()}, "
            f"windows {res.windows}, dual iters {res.dual_iters}, hedged "
            f"{res.hedged}, failures {res.failures}, retries {res.retries}, "
            f"trips {res.breaker_trips}")


def hold_vote_calls(torch, say, check, calls, tag):
    """3a's contract on the kept vote launches, over all their rows: vals
    within 1e-5, sorted index rows equal on >= 0.999 of the rows, votes
    within 1e-5 relative to max(1, |vote|) on the rows whose index sets
    agree.  Returns (largest error, windows whose index sets differ)."""
    from repro_torch.kernels.topk_retrieval.ref import retrieval_vote_ref
    err_vals = err_vote = rel = 0.0
    rows = same_rows = differ = 0
    for (store, labels, q, k), kw, out in calls:
        ref = retrieval_vote_ref(store, labels, q, k, kw.get("n_valid"))
        same = (torch.sort(out[1], 1).values
                == torch.sort(ref[1], 1).values).all(1)
        err_vals = max(err_vals, float((out[0] - ref[0]).abs().max()))
        if bool(same.any()):
            d = (out[2] - ref[2])[same].abs()
            err_vote = max(err_vote, float(d.max()))
            rel = max(rel, float((d / torch.clamp(ref[2][same].abs(),
                                                  min=1.0)).max()))
        rows += q.shape[0]
        same_rows += int(same.sum())
        differ += int(not bool(same.all()))
    agree = same_rows / max(rows, 1)
    say(f"{tag}: vote kernel vs plain version on {len(calls)} windows "
        f"({rows} rows): max|dvals|={err_vals:.3g}, idx agree={agree:.6f} "
        f"({differ} windows with a differing index set), "
        f"max|dvote|={err_vote:.3g} (relative {rel:.3g})")
    check(len(calls) > 0, f"{tag}: no vote launch was kept")
    check(err_vals <= 1e-5, f"{tag}: vote vals")
    check(agree >= 0.999, f"{tag}: vote idx sets")
    check(rel <= 1e-5, f"{tag}: votes")
    return max(err_vals, err_vote), differ


def percentiles(np, xs):
    return (float(np.median(xs)), float(np.percentile(xs, 90))) if xs else (
        0.0, 0.0)


def serving_sim_phase(torch, np, dev, say, check, big_retrieval, route_ds,
                      fits):
    """S: ``run_serving`` on the card through ``OmniRouter`` over ECCOS-R.

    S1, the paper's Table 2 pool: batching (the fused dual solve), the
    streaming strawman over the first 108 queries, and batching with
    ``fold_online``; then the other five policies of Table 2 in batching
    mode (BA, S3, PO, and ECCOS-T and ECCOS-H behind ``OmniRouter``; the
    fitted ones from phase T's ``fits``).  S2, ``benchmarks/bench_robust.py``'s degraded pool:
    healthy, naive and robust (breakers + LCB solve) streams.  Every
    window's vote launch is held to its plain version on the card; every
    run is replayed on the CPU (in worker processes, after the card's
    runs) against the card's predictions, whose ``ServeResult`` must equal
    the card's and whose blocked-ascent calls, the plain version on the
    card's launches' inputs, must equal the card's bit for bit; a plain
    CPU run with its own predictions is printed beside it.  S3: a
    16,384-query Poisson stream over the 131,072-row store, every 16th
    window's launches held.  The CPU runs of S1's trained policies are
    phase T's CPU fits.  Returns the launches of rows 1, 2 and 4, the
    largest vote and blocked errors, the per-run summaries and the CPU
    fits' infos."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.core import (OmniRouter, RetrievalPredictor,
                                  RouterConfig, SchedulerConfig, run_serving)
    from repro_torch.core import optimizer as opt
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    from repro_torch.serving import faults

    t_phase = time.perf_counter()
    total = dict(vote=0, dual_solve=0, blocked=0)
    errs = dict(vote=0.0, blocked=0.0)
    summary, card, cpu_jobs, cpu_fits = {}, {}, [], {}

    def card_run(tag, ds, router, cfg, every=1, hold=True, voted=True):
        """One run on the card: launches counted from 0, every
        ``every``-th vote and blocked launch kept, the votes held (a
        policy that votes must have launched the vote), per-window route
        times (by part behind ``OmniRouter``), the simulation's wall
        time."""
        laps = []
        timed = hasattr(router, "last_timing")
        for name in ("route", "route_window") if timed else ("route",):
            fn = getattr(router, name)

            def lapped(*a, _fn=fn, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                laps.append(dict(router.last_timing) if timed else
                            {"route_s": time.perf_counter() - t0})
                return out
            setattr(router, name, lapped)
        votes = KeptCalls(tr_ops, "retrieval_vote", every)
        blocked = KeptCalls(la_ops, "blocked_dual_ascent", every)
        votes.on = blocked.on = hold
        tr_ops.launches = la_ops.launches = la_ops.blocked_launches = 0
        reads0 = opt.solve_host_reads
        t0 = time.perf_counter()
        try:
            res = run_serving(ds, router, cfg)
            torch.cuda.synchronize()
        finally:
            votes.restore()
            blocked.restore()
        wall = time.perf_counter() - t0
        n = dict(vote=tr_ops.launches, dual_solve=la_ops.launches,
                 blocked=la_ops.blocked_launches)
        reads = opt.solve_host_reads - reads0
        for key in total:
            total[key] += n[key]
        parts = {p: [lap[p] * 1e3 for lap in laps]
                 for p in (("tokenize_s", "predict_solve_s", "polish_s")
                           if timed else ("route_s",))}
        whole = [sum(v) for v in zip(*parts.values())]
        med, p90 = percentiles(np, whole)
        split = ", ".join(f"{p[:-2]} {percentiles(np, v)[0]:.2f}/"
                          f"{percentiles(np, v)[1]:.2f}"
                          for p, v in parts.items())
        ratio = res.scheduling_seconds / max(res.llm_seconds, 1e-12)
        say(f"{tag} (card): {result_line(res)}")
        say(f"{tag} (card): {len(laps)} routed windows, route ms a window "
            f"median {med:.2f} / p90 {p90:.2f} ({split}); scheduling "
            f"{res.scheduling_seconds:.3f} s, LLM {res.llm_seconds:.1f} s, "
            f"ratio {ratio:.3g}; simulation wall {wall:.2f} s; launches "
            f"{n}, solve host reads {reads}")
        check(len(laps) == res.windows, f"{tag}: a window went unrouted")
        check(n["vote"] > 0 if voted else n["vote"] == 0,
              f"{tag}: vote launches {n['vote']}")
        vote_differ = 0
        if hold and voted:
            e, vote_differ = hold_vote_calls(torch, say, check, votes.calls,
                                             tag)
            errs["vote"] = max(errs["vote"], e)
        summary[tag] = dict(windows=res.windows, dual_iters=res.dual_iters,
                            route_ms_median=med, route_ms_p90=p90,
                            scheduling_s=res.scheduling_seconds,
                            llm_s=res.llm_seconds, ratio=ratio,
                            makespan_s=res.makespan, wall_s=wall,
                            launches=n, solve_host_reads=reads,
                            sr=res.success_rate, cost=res.cost,
                            vote_windows_differ=vote_differ)
        return res, n, reads, blocked.calls

    def card_case(tag, case, rec, res, blocked_calls):
        """Queue the CPU replay of a card run and the plain CPU run."""
        card[tag] = res
        calls = [_host(c) for c in rec.calls] if rec is not None else []
        kept = [(_host(a), _host(kw), _host(out[0]))
                for a, kw, out in blocked_calls]
        cpu_jobs.append((tag, "replay", (
            case, calls, getattr(rec, "token_len", None), kept)))
        cpu_jobs.append((tag, "plain", (case,)))

    # S1. the paper's Table 2 pool at paper scale: ECCOS-R in three
    # modes, then the other five policies in batching mode
    table2 = {}
    for tag in ("S1 batching", "S1 streaming", "S1 batching fold_online",
                *(f"S1 batching {p}" for p in TABLE2 if p != "ECCOS-R")):
        case = train, ds, rkw, skw, name = sim_case(tag)
        pred = (fits[name][0] if name in fits
                else table2_predictor(name, train, dev)[0])
        ret = getattr(pred, "retrieval", pred)
        size0 = getattr(getattr(ret, "vstore", None), "size", None)
        rec = RecordedPredictor(pred) if pred is not None else None
        router = table2_policy(name, rec, rkw)
        res, n, _, bl = card_run(tag, ds, router, SchedulerConfig(**skw),
                                 voted=name in ("ECCOS-R", "ECCOS-H", "PO"))
        check(res.per_model_counts.sum() == ds.n and res.failures == 0,
              f"{tag}: not every query served")
        check(n["dual_solve"] > 0 if name.startswith("ECCOS")
              else n["dual_solve"] == 0,
              f"{tag}: dual solve launches {n['dual_solve']}")
        if skw["fold_online"]:
            say(f"{tag}: store {size0} -> {ret.vstore.size} rows "
                f"(capacity {ret.vstore.capacity})")
            check(ret.vstore.size == size0 + ds.n,
                  f"{tag}: the store did not grow by {ds.n}")
        if skw["mode"] == "batching" and not skw["fold_online"]:
            table2[name] = res
        card_case(tag, case, rec, res, bl)
    say("S1 Table 2 on the card (batching, alpha 0.75, loads 4, "
        f"{ds.n} test queries): " + "; ".join(
            f"{p} SR {table2[p].success_rate:.4f} $ {table2[p].cost:.6f}"
            for p in TABLE2))

    # S2. benchmarks/bench_robust.py's degraded pool at its full size
    ret2 = None
    for tag in ("S2 healthy", "S2 naive", "S2 robust"):
        case = train, test, rkw, skw, _ = sim_case(tag)
        budget2 = rkw["budget"]
        ret2 = ret2 or RetrievalPredictor(k=8, device=dev).fit(train)
        rec = RecordedPredictor(ret2)
        router = OmniRouter(rec, RouterConfig(**rkw), name="ECCOS-R")
        cfg = SchedulerConfig(**skw)
        faults.reset_counters()
        if rkw["robust"]:
            # a warm-up pass, then the timed pass on the same router
            warm, _, _, _ = card_run(tag + " warm-up", test, router, cfg,
                                     hold=False)
            rec.calls.clear()
        res, n, reads, bl = card_run(tag, test, router, cfg)
        check(n["blocked"] > 0 and len(bl) == n["blocked"],
              f"{tag}: a blocked ascent launch was not made or not kept")
        check(reads == 0, f"{tag}: the padded solve read the host")
        if tag == "S2 healthy":
            say(f"{tag}: fault counters {faults.counters}")
            check(faults.counters == {"checks": 0, "injected": 0},
                  f"{tag}: the fault plane did work with no plan attached")
        if rkw["robust"]:
            check(not result_diff(warm, res),
                  f"{tag}: the timed pass differs from the warm-up pass")
        card_case(tag, case, rec, res, bl)
    healthy, naive, robust = (card[k] for k in ("S2 healthy", "S2 naive",
                                                "S2 robust"))
    say(f"S2 acceptance: robust SR {robust.success_rate:.4f} vs 0.95 x "
        f"healthy {0.95 * healthy.success_rate:.4f}; robust $ "
        f"{robust.cost:.6f} vs B {budget2:.6f}; naive SR "
        f"{naive.success_rate:.4f}; trips {robust.breaker_trips}")
    check(robust.success_rate >= 0.95 * healthy.success_rate,
          "S2: robust SR below 0.95 x healthy")
    check(robust.cost <= budget2 * 1.0001, "S2: robust overspent B")
    check(robust.success_rate > naive.success_rate,
          "S2: robust did not beat naive")
    check(robust.breaker_trips >= 1, "S2: no breaker tripped")

    # G2 (simulator). S2's healthy stream again with LedgerSan and
    # SolveCert on
    summary["G2 S2 healthy"] = g2_sim_stream(
        torch, say, check, ret2, card["S2 healthy"],
        summary["S2 healthy"]["wall_s"])
    for key in ("vote", "blocked"):
        total[key] += summary["G2 S2 healthy"]["launches"][key]

    # S3. a 16,384-query stream on the routing plane's 131,072-row store
    rate = route_ds.n / S3_SECONDS
    budget3 = 2.5 * float(route_ds.cost_matrix().min(1).sum())
    cfg3 = SchedulerConfig(arrival="poisson", arrival_rate=rate,
                           window=S3_WINDOW_ARRIVALS / rate,
                           streaming_dual=True, horizon=route_ds.n,
                           tokens_per_sec=S3_TOKENS_PER_SEC, loads=S3_LOADS)
    res3, n3, reads3, bl3 = card_run(
        "S3 stream", route_ds, OmniRouter(big_retrieval, RouterConfig(
            budget=budget3), name="ECCOS-R"), cfg3, every=S3_HOLD_EVERY)
    e, _ = hold_blocked_calls(torch, say, check, bl3, "S3 stream")
    errs["blocked"] = max(errs["blocked"], e)
    say(f"S3 stream: {route_ds.n} queries at {rate:.1f}/s, window "
        f"{cfg3.window:.4f} s, loads {S3_LOADS} x {route_ds.m}, store "
        f"{big_retrieval.vstore.size} rows; $ {res3.cost:.4f} vs B "
        f"{budget3:.4f} ({res3.cost / budget3:.4f} B)")
    check(res3.per_model_counts.sum() == route_ds.n and res3.failures == 0,
          "S3: not every query served")
    check(res3.cost <= 1.05 * budget3, "S3: spent more than 1.05 B")
    check(res3.windows > 100 and res3.dual_iters > 0,
          "S3: too few windows or no dual iterations")
    check(n3["blocked"] > 0 and reads3 == 0,
          "S3: no blocked launch, or the solve read the host")

    # the CPU runs of S1 and S2, in worker processes, the longest (S2's
    # and the fits of phase T) first
    def longest_first(job):
        tag, kind, _ = job
        return not (tag.startswith("S2") or (
            kind == "plain" and tag.split()[-1] in FITTED))

    t0 = time.perf_counter()
    with ProcessPoolExecutor(CPU_WORKERS, multiprocessing.get_context(
            "spawn")) as pool:
        futures = [(tag, kind, pool.submit(cpu_sim_job, *args))
                   for tag, kind, args in sorted(cpu_jobs,
                                                 key=longest_first)]
        for tag, kind, fut in futures:
            try:
                res, seconds, bad, fit = fut.result()
            except RuntimeError as err:
                check(False, f"{tag}: CPU {kind}: {err}")
            if fit is not None:
                cpu_fits[tag.split()[-1]] = fit
            diff = result_diff(res, card[tag])
            if kind == "replay":
                say(f"{tag}: CPU replay on the card's predictions "
                    f"({seconds:.2f} s): differing fields {diff}; blocked "
                    f"launches held bit for bit to the plain version on "
                    f"their inputs: {summary[tag]['launches']['blocked']}, "
                    f"differing {bad}")
                check(not diff, f"{tag}: the CPU replay's ServeResult "
                      f"differs from the card's in {diff}")
                check(not bad, f"{tag}: blocked launches {bad} differ from "
                      "the plain version on their inputs")
            else:
                say(f"{tag} (CPU, own predictions, {seconds:.2f} s): "
                    f"{result_line(res)}; differing from the card's in "
                    f"{diff}")
    say(f"phase S CPU runs: {len(futures)} in {CPU_WORKERS} processes, "
        f"{time.perf_counter() - t0:.1f} s")
    seconds = time.perf_counter() - t_phase
    say(f"phase S: {seconds:.1f} s; launches (vote, dual solve, blocked) "
        f"{total}")
    return dict(launches=total, errs=errs, runs=summary, seconds=seconds,
                cpu_fits=cpu_fits)


# -- phase G: the sanitizer plane and the runtime guards on the card ----------

G3_SEEDS = (0, 1, 2)
G3_STORM = 64           # tie-storm queries (equal service times)
G4_WINDOW = (3000, 4096)   # V2's first window: (valid rows, padded rows)


def race_phase(torch, np, dev, say, check):
    """G3: the schedule race checker on the card.  The engine explorer over
    E1's float32 smoke pool (hedging after 2 chunks, PageSan on, the
    engine's chunk, completion, hedge and fault orders permuted per seed),
    and the simulator explorer over a tie storm (every service time equal,
    loads ample) routed by ECCOS-R on the card; G3_SEEDS seeds each.  The
    routed outputs must not depend on the seed and every per-run invariant
    holds (the explorers raise otherwise).  The engine pass runs under
    ``CompileGuard()``: E1 has built and loaded every kernel it launches,
    so it must count no compile event.  Returns the card's launches."""
    import dataclasses
    from repro_torch.analysis import sanitize
    from repro_torch.analysis.sanitize import racecheck
    from repro_torch.common import CompileGuard
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import BalanceAware, SchedulerConfig
    from repro_torch.data.qaserve import generate
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import (Endpoint, MultiLLMServer, Request,
                                            null_route_features)
    t0 = time.perf_counter()
    cfgs = [dataclasses.replace(get_smoke_config(a), dtype=torch.float32)
            for a in E1_POOL]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 500, (9,)).astype(np.int32)
               for _ in range(E1_REQS)]
    pd_ops.launches = fa_ops.launches = 0
    with sanitize.enabled("pagesan"), CompileGuard(
            label="G3 engine exploration") as guard:
        ev0 = sanitize.counters["events"]
        eps = [Endpoint(c, device=dev, params=_tree_to(
            _f32(build_model(c).init(i, "cpu")), dev), **E1_EP)
            for i, c in enumerate(cfgs)]

        def make_server():
            srv = MultiLLMServer(eps, BalanceAware(), batch_size=2,
                                 hedge_after_steps=2)
            for rid, p in enumerate(prompts):
                srv.submit(Request(rid, p, max_new=E1_HEDGE_NEW))
            return srv, null_route_features

        report = racecheck.explore_engine_schedules(make_server,
                                                    seeds=G3_SEEDS)
        events = sanitize.counters["events"] - ev0
    engine = dict(paged=pd_ops.launches, flash=fa_ops.launches)
    finished = sum(1 for fp in report.fingerprint
                   if fp[1] and len(fp[3]) == E1_HEDGE_NEW)
    say(f"G3 engine race check (E1's float32 smoke pool on the card, hedge "
        f"after 2 chunks, PageSan on): {report.runs} seeds {report.seeds}, "
        f"one end state: {len(report.fingerprint)} requests, "
        f"{sum(len(fp[3]) for fp in report.fingerprint)} tokens; PageSan "
        f"events {events}; compile events {guard.retraces()}; launches "
        f"{engine}")
    check(report.runs == len(G3_SEEDS)
          and len(report.fingerprint) == E1_REQS and finished == E1_REQS,
          "G3 engine: a request was lost or unfinished")
    check(guard.retraces() == 0, "G3 engine: a compile event in a pass of "
          "E1's warmed kernels")
    check(events > 0 and engine["paged"] > 0,
          "G3 engine: no PageSan event or no kernel launch")

    train, _, test = generate(n=S1_N, seed=0).split()

    def make_args():
        ds = test.subset(np.arange(G3_STORM))
        ds.out_len[:, :] = 40                  # maximal finish-time ties
        pred, _ = table2_predictor("ECCOS-R", train, dev)
        return ds, table2_policy("ECCOS-R", pred, dict(alpha=S1_ALPHA)), \
            SchedulerConfig(loads=G3_STORM, seed=3)

    tr_ops.launches = la_ops.launches = 0
    sim = racecheck.explore_sim_schedules(make_args, seeds=G3_SEEDS)
    sim_n = dict(vote=tr_ops.launches, dual_solve=la_ops.launches)
    say(f"G3 simulator race check (tie storm: {G3_STORM} queries, every "
        f"service time 40 tokens, loads {G3_STORM}, ECCOS-R on the card): "
        f"{sim.runs} seeds {sim.seeds}, one end state: $ {sim.fingerprint[2]}"
        f", assignment counts {np.bincount(sim.fingerprint[0]).tolist()}; "
        f"launches {sim_n}; G3 {time.perf_counter() - t0:.1f} s")
    check(sim.runs == len(G3_SEEDS) and sim_n["vote"] > 0
          and sim_n["dual_solve"] > 0,
          "G3 simulator: the card's kernels did not route the storm")
    return dict(paged=engine["paged"], flash=engine["flash"], **sim_n)


def sync_sites(torch, fn):
    """Runs ``fn`` with the CUDA sync debug mode at "warn" and returns the
    call sites (innermost repository frames) of every synchronizing
    operation it made, each with its count."""
    import traceback
    import warnings
    sites = {}
    show = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return show(message, category, filename, lineno, file, line)
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "repro_torch" in f.filename]
        key = (f"{Path(frames[-1].filename).name}:{frames[-1].lineno} "
               f"({frames[-1].name})" if frames else f"{filename}:{lineno}")
        sites[key] = sites.get(key, 0) + 1

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    return sites


def guards_phase(torch, np, dev, say, check, cost, cap):
    """G4: the runtime guards on the card.  ``no_host_sync`` is live (a
    deliberate ``.item()`` raises inside it, ``device_get`` does not);
    ``DualSolver.solve`` and ``route_arrays`` at route-quality-16k's shape
    (the route batch's predictions, N 16,384, M 6) and one masked blocked
    window at V2's shape (3,000 valid rows padded to 4,096) pass under it,
    each first run with the sync debug mode at "warn" to list any implicit
    sync's call site; the explicit reads each makes are printed.  The
    checked passes run under ``CompileGuard()`` (the kernels are built and
    loaded by then).  Returns the launches of the dual solve (row 1) and
    the blocked ascent (row 4)."""
    from repro_torch.common import (CompileGuard, device_get, guards,
                                    no_host_sync)
    from repro_torch.core import optimizer as opt
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    x = torch.arange(4.0, device=dev)
    fired = None
    with no_host_sync():
        try:
            x.sum().item()
        except RuntimeError as err:
            fired = str(err).splitlines()[0]
        got = device_get(x.sum())
    say(f"G4 no_host_sync: a deliberate .item() raised: {fired!r}; "
        f"device_get inside it read {float(got)}")
    check(fired is not None and "synchroniz" in fired,
          "G4: no_host_sync did not fire on .item()")
    check(float(got) == 6.0, "G4: device_get read a wrong value")

    m = cost.shape[1]
    loads = np.full(m, float(int(0.3 * N_ROUTE)))
    solver = opt.DualSolver(mode="quality", iters=150)
    nv, n_pad = G4_WINDOW
    c_w = torch.zeros(n_pad, m, device=dev)
    q_w = torch.zeros(n_pad, m, device=dev)
    c_w[:nv], q_w[:nv] = cost[:nv], cap[:nv]
    c_w[nv:], q_w[nv:] = 7.0, 0.5           # garbage in the padding
    w_solver = opt.DualSolver(mode="quality", iters=150, lr_constraint=3.0,
                              stall_tol=1e-2, norm_grad=True)
    w_loads = torch.full((m,), float(nv // 4), device=dev)
    runs = {
        "solve 16k": lambda: solver.solve(cost, cap, 0.75, loads),
        "route_arrays 16k": lambda: solver.route_arrays(
            cost, cap, 0.75, loads, polish_threshold=0.78),
        f"masked window {nv}/{n_pad}": lambda: w_solver.route_window(
            c_w, q_w, 0.75, w_loads, opt.init_dual_state(m, dev),
            share=0.25, polish_margin=0.03, n_valid=nv),
    }
    out = {}
    la_ops.launches = la_ops.blocked_launches = 0
    for tag, fn in runs.items():
        sites = sync_sites(torch, fn)
        fetch0 = guards.host_reads
        raised = None
        with CompileGuard(max_retraces=None, label=f"G4 {tag}") as cg:
            try:
                with no_host_sync():
                    res = fn()
            except RuntimeError as err:
                raised = str(err).splitlines()[0]
            torch.cuda.synchronize()
        out[tag] = dict(implicit_sync_sites=sites,
                        explicit_reads=guards.host_reads - fetch0,
                        compile_events=cg.retraces())
        say(f"G4 {tag} under no_host_sync: implicit syncs (warn pass) "
            f"{sites or 'none'}; raised {raised!r}; explicit reads "
            f"(device_get) {out[tag]['explicit_reads']}; compile events "
            f"{cg.retraces()}")
        check(raised is None and not sites,
              f"G4 {tag}: an implicit host sync under no_host_sync")
        check(cg.retraces() == 0, f"G4 {tag}: a compile event in a warmed "
              "pass")
        want = n_pad if "masked" in tag else cost.shape[0]
        check(raised is not None or (tuple(res[0].shape) == (want,) and int(
            res[0].min()) >= 0 and int(res[0].max()) < m),
              f"G4 {tag}: the assignment's shape or range")
    n = dict(dual_solve=la_ops.launches, blocked=la_ops.blocked_launches)
    say(f"G4 launches {n}")
    check(n["dual_solve"] > 0 and n["blocked"] > 0,
          "G4: the solves did not launch the kernels")
    return n, out


# -- phase I: int8 KV pools ----------------------------------------------------

def int8_check(torch, np, model, params, dev, say, check, tag, limits):
    """I1's checked comparison on ``model`` (int8 KV, full width and depth):
    four ragged prompts prefilled alone into int8 pools, CHECK_STEPS
    teacher-forced ``decode_step_paged`` steps (the dense-cache kernel on
    the pools' dequantized view) against each sequence's dense int8 path
    (``decode_step`` over ``pad_cache``); then one ``verify_step_paged``
    round of SPEC_K positions (the dense-cache kernel at SPEC_K positions
    over the same view) against SPEC_K sequential paged decode steps at
    lens + s on a copy of the pools.  Both held to ``limits`` ((max
    relative difference, least argmax agreement)).  Then the two wrappers
    on layer 0's view against their plain versions (``hold_dense_view``).
    Returns the figures and the launches."""
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.transformer import _dense_view
    from repro_torch.models.zoo import pad_cache, prefill_into_pages
    cfg = model.cfg
    vocab = cfg.vocab_size
    rng = np.random.RandomState(0)
    plens = [100, 237, 480, 511]
    ps, nb = 16, len(plens)
    extra = CHECK_STEPS + SPEC_K
    p_max = -(-(max(plens) + extra) // ps)
    seqs = [rng.randint(1, vocab, (n + extra,)) for n in plens]
    state = model.empty_paged_state(nb, 1 + nb * p_max, ps, device=dev)
    check(state["segs"][0][0]["k"].dtype == torch.int8
          and "k_scale" in state["segs"][0][0], f"I1 {tag}: pools not int8")
    bt = torch.arange(1, 1 + nb * p_max, dtype=torch.int32,
                      device=dev).reshape(nb, p_max)
    fa_ops.launches = pd_ops.dense_launches = pd_ops.verify_launches = 0
    pd_ops.launches = 0
    caches = []
    for i, n in enumerate(plens):
        cache, _ = model.prefill(params, torch.as_tensor(seqs[i][None, :n],
                                                         device=dev))
        prefill_into_pages(state, cache, bt[i, :-(-n // ps)].long(), i, ps)
        caches.append(pad_cache(cache, n + CHECK_STEPS))
    lens = torch.as_tensor(plens, dtype=torch.int32, device=dev)

    def tokens(t, width=1):
        return torch.as_tensor(np.array([s[n + t:n + t + width] for s, n in
                                         zip(seqs, plens)]),
                               dtype=torch.int32, device=dev)

    dec = []
    for t in range(CHECK_STEPS):
        _, lg = model.decode_step_paged(params, state, tokens(t), bt, lens)
        dec.append(lg[:, :vocab])
        lens = lens + 1
    ref = []
    for i, n in enumerate(plens):
        c, out = caches[i], []
        for t in range(CHECK_STEPS):
            c, lg = model.decode_step(params, c, torch.as_tensor(
                [[seqs[i][n + t]]], dtype=torch.int32, device=dev))
            out.append(lg[0, :vocab])
        ref.append(torch.stack(out))
    del caches
    dec, ref = torch.stack(dec, dim=1), torch.stack(ref)
    torch.cuda.synchronize()
    n_dense = pd_ops.dense_launches
    check(n_dense == cfg.n_layers * CHECK_STEPS * (nb + 1),
          f"I1 {tag}: dense kernel launches != layers x steps x (1 paged + "
          f"{nb} dense)")
    check(pd_ops.launches == 0, f"I1 {tag}: int8 pools ran the bf16 paged "
          "kernel")
    check(bool(torch.isfinite(dec).all() and torch.isfinite(ref).all()),
          f"I1 {tag}: non-finite logits")
    rel = float((dec - ref).abs().max() / ref.abs().max())
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    # one verify round against sequential decode at lens + s
    copy = {"segs": [[{k: v.clone() for k, v in layer.items()}
                      for layer in seg] for seg in state["segs"]]}
    vt = tokens(CHECK_STEPS, SPEC_K)
    n_dense = pd_ops.dense_launches
    _, vlg = model.verify_step_paged(params, state, vt, bt, lens)
    seq = []
    for j in range(SPEC_K):
        _, lg = model.decode_step_paged(params, copy, vt[:, j:j + 1], bt,
                                        lens + j)
        seq.append(lg[:, :vocab])
    seq = torch.stack(seq, dim=1)
    vlg = vlg[:, :, :vocab]
    torch.cuda.synchronize()
    n_verify = pd_ops.dense_launches - n_dense
    check(n_verify == cfg.n_layers * (1 + SPEC_K),
          f"I1 {tag}: dense-cache launches of the verify round and its "
          f"{SPEC_K} decode steps != layers x {1 + SPEC_K}")
    check(pd_ops.verify_launches == 0, f"I1 {tag}: int8 pools ran the paged "
          "verify kernel")
    n_dense = pd_ops.dense_launches
    kernel_err = hold_dense_view(torch, say, check, cfg, *_dense_view(
        cfg, state["segs"][0][0], 0, bt), lens, f"I1 {tag}")
    vrel = float((vlg - seq).abs().max() / seq.abs().max())
    vagree = float((vlg.argmax(-1) == seq.argmax(-1)).float().mean())
    say(f"I1 {tag}: danube full width, int8 pools, {nb} sequences (prompts "
        f"{plens}) x {CHECK_STEPS} teacher-forced paged decode steps vs the "
        f"dense int8 path (decode_step over pad_cache, one sequence at a "
        f"time): max|diff|/max|logit| = {rel:.4g}, argmax agreement "
        f"{agree:.4f}; one verify round of {SPEC_K} positions vs sequential "
        f"paged decode at lens + s: {vrel:.4g}, {vagree:.4f} (limits: <= "
        f"{limits[0]}, >= {limits[1]}); dense-cache launches {n_dense} "
        f"(of them the verify round and its decode steps {n_verify}), flash "
        f"{fa_ops.launches}")
    check(rel <= limits[0] and agree >= limits[1],
          f"I1 {tag}: paged int8 decode disagrees with the dense int8 path")
    check(vrel <= limits[0] and vagree >= limits[1],
          f"I1 {tag}: int8 verify disagrees with int8 decode at lens + s")
    return dict(rel=rel, agree=agree, verify_rel=vrel, verify_agree=vagree,
                dense=n_dense, flash=fa_ops.launches, kernel_err=kernel_err)


def hold_dense_view(torch, say, check, cfg, kd, vd, lens, tag):
    """The dense-cache kernel's two wrappers, ``ops.decode_attention`` and
    ``ops.verify_attention`` (SPEC_K positions), on one layer's dequantized
    int8 view ``kd``/``vd`` (B, T, K, D) at ``lens``, the tensors the int8
    path gives them, with seeded queries: each against its plain version
    (``decode_attention_ref`` / ``verify_attention_ref``) on the same
    tensors, max|diff| / max|plain| within FULL_LIMITS of the view's dtype.
    These launches are not the path's: the count is put back.  Returns
    the largest |kernel - plain|."""
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, verify_attention_ref)
    b, t = kd.shape[:2]
    limit = FULL_LIMITS["float32" if kd.dtype == torch.float32 else "bf16"][0]
    gen = torch.Generator(device=kd.device).manual_seed(b)
    window = cfg.sliding_window or 0
    n0, out = pd_ops.dense_launches, {}
    for name, s, fn, ref in (
            ("decode", 1, pd_ops.decode_attention, decode_attention_ref),
            ("verify", SPEC_K, pd_ops.verify_attention, verify_attention_ref)):
        q = torch.randn(b, s, cfg.n_heads, cfg.hd, generator=gen,
                        device=kd.device).to(kd.dtype)
        got = fn(q, kd, vd, lens, window=window)
        want = ref(q, kd, vd, lens, window=window)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        out[name] = err
        say(f"{tag}: ops.{fn.__name__} on layer 0's dequantized int8 view "
            f"(B={b}, T={t}, S={s}, lens {int(lens.min())}..{int(lens.max())}"
            f", {kd.dtype}) vs {ref.__name__}: max|kernel-plain| = {err:.3g},"
            f" relative {rel:.3g} (limit {limit})")
        check(rel <= limit, f"{tag}: ops.{fn.__name__} disagrees with its "
              "plain version on the int8 view")
    check(pd_ops.dense_launches == n0 + 2, f"{tag}: the wrappers did not "
          "launch the dense-cache kernel")
    pd_ops.dense_launches = n0
    return max(out.values())


def int8_serve(torch, np, dev, say, check, cfg, params, prompts):
    """S4's endpoint (L 16, t_max 2048, PS 16, sync_every 8) over
    ``prompts`` x MAX_NEW tokens in ``cfg``'s KV dtype: the outputs, the
    median ms a decode step and tokens/s, the prefill median and the peak
    device memory from construction on.  Int8 pools: after admission, the
    dense-cache wrappers on layer 0's dequantized view at this shape
    (``hold_dense_view``; outside the timed chunks)."""
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.transformer import _dense_view
    from repro_torch.serving.engine import Endpoint, Request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ep = Endpoint(cfg, max_concurrency=ENDPOINT_REQS, t_max=2048,
                  page_size=16, sync_every=8, params=params, device=dev)
    reqs = [Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    pd_ops.launches = pd_ops.dense_launches = fa_ops.launches = 0
    pre_ms = []
    for r in reqs:
        t0 = time.perf_counter()
        ep.admit(r)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    kernel_err = None
    if cfg.kv_cache_dtype == "int8":
        kernel_err = hold_dense_view(
            torch, say, check, cfg, *_dense_view(
                cfg, ep._state["segs"][0][0], 0,
                torch.as_tensor(ep.block_table, device=dev)),
            torch.as_tensor(ep.lens + 1, device=dev), "I1 S4 shape")
    chunk_ms, done = [], []
    while ep.active_count():
        t0 = time.perf_counter()
        done += ep.step()
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    chunk = float(np.median(chunk_ms[1:] or chunk_ms))
    out = dict(outputs={r.rid: list(r.output) for r in done},
               step_ms=chunk / ep.sync_every,
               tokens_s=ep.L * ep.sync_every / chunk * 1e3,
               prefill_ms=float(np.median(pre_ms)),
               peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
               pool_gib=sum(t.numel() * t.element_size()
                            for t in _leaves(ep._state)) / 2 ** 30,
               paged=pd_ops.launches, dense=pd_ops.dense_launches,
               flash=fa_ops.launches, drained=_drained(ep),
               n=len(done), kernel_err=kernel_err)
    del ep
    return out


def int8_phase(torch, np, dev, say, check, cfg, params, prompts):
    """I1: h2o-danube-3-4b at full width and depth with
    ``kv_cache_dtype="int8"``.  Checked (``int8_check``, wq/wk rescaled by
    ``_unit_fan_in``, FULL_LIMITS): float32 and bf16, paged against the
    dense int8 path and one verify round against decode at lens + s.
    Printed only (quantization changes the function): S4's endpoint over
    S4's prompts with int8 pools beside bf16 pools on the same unit-score
    bf16 weights: argmax (token) agreement, peak memory, ms a decode step
    and tokens/s.  Returns the launches by kernel."""
    import dataclasses
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    cfg8_32 = dataclasses.replace(cfg8, dtype=torch.float32)
    p32 = _unit_fan_in(_tree_to(params, torch.float32))
    f32 = int8_check(torch, np, build_model(cfg8_32), p32, dev, say, check,
                     "float32, unit-std scores", FULL_LIMITS["float32"])
    del p32
    unit = _unit_fan_in(params)
    b16 = int8_check(torch, np, build_model(cfg8), unit, dev, say, check,
                     "bf16, unit-std scores", FULL_LIMITS["bf16"])
    runs = {"int8": int8_serve(torch, np, dev, say, check, cfg8, unit,
                               prompts),
            "bf16": int8_serve(torch, np, dev, say, check, cfg, unit,
                               prompts)}
    del unit
    for tag, r in runs.items():
        check(r["n"] == ENDPOINT_REQS and r["drained"] and all(
            len(o) == MAX_NEW for o in r["outputs"].values()),
            f"I1 {tag} pools: not every request got {MAX_NEW} tokens, or a "
            "leak")
    i8, bf = runs["int8"], runs["bf16"]
    check(i8["dense"] > 0 and i8["paged"] == 0 and bf["paged"] > 0
          and bf["dense"] == 0, "I1: a pool kind took the other's kernel")
    same = np.mean([a == b for rid in i8["outputs"] for a, b in
                    zip(i8["outputs"][rid], bf["outputs"][rid])])
    first = np.mean([i8["outputs"][rid][0] == bf["outputs"][rid][0]
                     for rid in i8["outputs"]])
    say(f"I1 serving (S4's endpoint: L {ENDPOINT_REQS}, t_max 2048, PS 16, "
        f"prompts {min(map(len, prompts))}..{max(map(len, prompts))} x "
        f"{MAX_NEW} tokens, unit-std-score bf16 weights; {gpu_line()}): "
        f"int8 pools {i8['pool_gib']:.3f} GiB, peak {i8['peak_gib']:.2f} "
        f"GiB above the weights, {i8['step_ms']:.2f} ms a decode step, "
        f"{i8['tokens_s']:.1f} tokens/s, prefill {i8['prefill_ms']:.1f} ms "
        f"(median) | bf16 pools {bf['pool_gib']:.3f} GiB, peak "
        f"{bf['peak_gib']:.2f} GiB, {bf['step_ms']:.2f} ms a step, "
        f"{bf['tokens_s']:.1f} tokens/s, prefill {bf['prefill_ms']:.1f} ms "
        f"| greedy tokens equal to the bf16 run's: {same:.4f} of "
        f"{ENDPOINT_REQS * MAX_NEW}, first tokens {first:.4f} (printed, not "
        f"checked); I1 {time.perf_counter() - t0:.1f} s")
    return dict(dense=f32["dense"] + b16["dense"] + i8["dense"],
                kernel_err=max(f32["kernel_err"], b16["kernel_err"],
                               i8["kernel_err"]), paged=bf["paged"],
                flash=f32["flash"] + b16["flash"] + i8["flash"]
                + bf["flash"], float32=f32, bf16=b16,
                serve={k: {f: v for f, v in r.items() if f != "outputs"}
                       for k, r in runs.items()}, token_agreement=same)


def g2_sim_stream(torch, say, check, ret2, healthy, healthy_wall):
    """G2 (simulator): phase S's S2 healthy stream (ECCOS-R over ``ret2``,
    budget mode, Poisson arrivals, padded windows) again with LedgerSan
    and SolveCert on: every window certified and its ledger checked, no
    violation raised, and the ServeResult equal to the sanitizer-off card
    run's (``healthy``) in every field but the wall time."""
    from repro_torch.analysis import sanitize
    from repro_torch.core import (OmniRouter, RouterConfig, SchedulerConfig,
                                  run_serving)
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    _, test, rkw, skw, _ = sim_case("S2 healthy")
    router = OmniRouter(ret2, RouterConfig(**rkw), name="ECCOS-R")
    with sanitize.enabled("ledgersan", "solvecert"):
        c0 = dict(sanitize.counters)
        tr_ops.launches = la_ops.blocked_launches = 0
        t0 = time.perf_counter()
        res = run_serving(test, router, SchedulerConfig(**skw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = {k: sanitize.counters[k] - c0[k] for k in c0}
    n = dict(vote=tr_ops.launches, blocked=la_ops.blocked_launches)
    diff = result_diff(res, healthy)
    say(f"G2 S2 healthy with LedgerSan + SolveCert (card): "
        f"{result_line(res)}; {moved['certs']} certificates and "
        f"{moved['checks']} ledger checks over {res.windows} windows, no "
        f"violation; simulation wall {wall:.2f} s (off: "
        f"{healthy_wall:.2f} s); launches {n}; differing from the "
        f"sanitizer-off run in {diff}")
    check(moved["certs"] == res.windows and moved["checks"] >= res.windows,
          "G2 S2 healthy: a window went uncertified or unchecked")
    check(not diff, f"G2 S2 healthy: the sanitized ServeResult differs in "
          f"{diff}")
    return dict(windows=res.windows, certs=moved["certs"],
                checks=moved["checks"], wall_s=wall, launches=n)


def slot_state_bytes(model):
    """Bytes of one slot's recurrent state (every leaf but the page
    pools' K/V), from a state on the meta device."""
    state = model.empty_paged_state(1, 1, 1, device="meta")
    return sum(t.numel() * t.element_size()
               for seg in state["segs"] for layer in seg
               for key, t in layer.items() if key not in ("k", "v"))


def full_width_recurrent(torch, np, dev, say, check, arch, seed):
    """H1 / H2: one recurrent family at full width and depth (random
    weights from ``seed``, attention and the recurrent projections at unit
    fan-in, ``_unit_fan_in``), teacher-forced paged decode against the
    full-sequence logits: in float32 held to ``FULL_LIMITS``; in bf16 held
    to that float32 full sequence (``TRUTH_FACTOR``; ``FULL_LIMITS``
    reported) and to the dense decode from the same prefills.  Returns
    (bf16 model, its rescaled params, the checks' results)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = _unit_fan_in(model.init(seed, dev))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    kinds = [k.block for c, p in model.plan for _ in range(c) for k in p]
    say(f"{arch} full width: {cfg.n_layers} layers "
        f"({', '.join(f'{kinds.count(b)} {b}' for b in sorted(set(kinds)))})"
        f" d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} "
        f"ssm_state={cfg.ssm_state} window={cfg.sliding_window} "
        f"V={cfg.vocab_size}; {n_par / 1e9:.3f} B params drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s; per-slot recurrent state "
        f"{slot_state_bytes(model) / 1e6:.3f} MB")
    model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    res = {}
    res["float32"] = full_width_check(
        torch, np, model32, _tree_to(params, torch.float32), dev, say, check,
        "float32, unit-std scores and fan-in", limits=FULL_LIMITS["float32"],
        plens=H_PROMPTS, steps=H_CHECK_STEPS)
    res["bf16"] = full_width_check(
        torch, np, model, params, dev, say, check,
        "bf16, unit-std scores and fan-in", plens=H_PROMPTS,
        steps=H_CHECK_STEPS, truth=res["float32"]["ref"], dense=True)
    lim = FULL_LIMITS["bf16"]
    within = res["bf16"]["rel"] <= lim[0] and res["bf16"]["agree"] >= lim[1]
    say(f"  {arch} bf16 against FULL_LIMITS {lim} (reported): "
        + ("within" if within else "outside"))
    for r in res.values():
        del r["ref"]
    return model, params, res


def drive_endpoint(torch, ep, todo, max_new, check, tag):
    """Admit every prompt, then step until all are done.  Returns the
    outputs by request id, admission ms, chunk ms and the flash, paged and
    dense decode launches."""
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serving.engine import Request
    reqs = [Request(i, p, max_new=max_new) for i, p in enumerate(todo)]
    fa_ops.launches = pd_ops.launches = pd_ops.dense_launches = 0
    pre_ms, chunk_ms, done = [], [], []
    for r in reqs:
        t0 = time.perf_counter()
        ep.admit(r)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    while ep.active_count():
        t0 = time.perf_counter()
        done += ep.step()
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    got = dict(flash=fa_ops.launches, paged=pd_ops.launches,
               dense=pd_ops.dense_launches)
    check(len(done) == len(todo) and all(
        r.done and len(r.output) == max_new for r in done),
          f"{tag} {type(ep).__name__}: not every request got {max_new} "
          "tokens")
    return {r.rid: list(r.output) for r in done}, pre_ms, chunk_ms, got


def hymba_endpoint_phase(torch, np, dev, say, check, model, params):
    """H3: hymba-1.5b at full width behind the serving engine at S4's
    shape: one paged ``Endpoint`` in bf16 admitting ENDPOINT_REQS ragged
    prompts (H_PROMPT_LO..H_PROMPT_HI, each prefilled at its exact length:
    per-slot recurrent state) and decoding MAX_NEW tokens each; then the
    same prompts cut to the shortest one's length, served in float32 for
    H_EQUAL_NEW tokens by a paged ``Endpoint`` and by a ``RestartEndpoint``
    (dense decode kernel), both holding all of them at once: the same
    greedy tokens (equal
    lengths: the restart batch has no left pads, ROADMAP C7).  float32, as
    R2 and the reference's own test: in bf16 the two engines' prefills
    (one request against the batch of 16) round apart and random-weight
    greedy decoding follows the roundings (0 of 16 equal, first
    differences at tokens 2-41, on an NVIDIA H100 80GB HBM3 at 700 W).
    Returns the launches."""
    import dataclasses
    from repro_torch.serving.engine import Endpoint, RestartEndpoint
    cfg = model.cfg
    n = ENDPOINT_REQS
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, (int(rng.randint(
        H_PROMPT_LO, H_PROMPT_HI + 1)),)).astype(np.int32) for _ in range(n)]
    launches = dict(flash=0, paged=0, dense=0)

    def drive(ep, todo, max_new):
        out = drive_endpoint(torch, ep, todo, max_new, check, "H3")
        for key in launches:
            launches[key] += out[3][key]
        return out

    torch.cuda.reset_peak_memory_stats()
    ep = Endpoint(cfg, max_concurrency=n, t_max=2048, page_size=16,
                  sync_every=8, params=params, device=dev)
    _, pre_ms, chunk_ms, got = drive(ep, prompts, MAX_NEW)
    steps = ep.busy_steps * ep.sync_every
    lay = cfg.n_layers
    check(ep.batch_reprefills == 0, "H3 endpoint: batch re-prefill")
    check(len(ep.alloc.free_pages) == ep.alloc.n_pages - 1
          and len(ep.alloc.free_slots) == ep.L, "H3 endpoint: allocator leak")
    check(got["flash"] == lay * n and got["paged"] == lay * steps
          and got["dense"] == 0,
          "H3 endpoint: launches != one flash per layer per admission and "
          "one paged decode per layer per step")
    steady = chunk_ms[1:] or chunk_ms
    chunk_med = float(np.median(steady))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"H3 endpoint (hymba-1.5b full width, bf16, H1's weights, "
        f"L={ep.L}, t_max={ep.t_max}, PS=16, sync_every=8, "
        f"{ep.alloc.n_pages} pages): {n} requests, prompts "
        f"{min(map(len, prompts))}..{max(map(len, prompts))}, {MAX_NEW} "
        f"tokens each | admission prefill {np.median(pre_ms):.1f} ms median "
        f"({min(pre_ms):.1f}..{max(pre_ms):.1f}) | decode chunk "
        f"{chunk_med:.1f} ms median = {chunk_med / ep.sync_every:.2f} ms a "
        f"step, {ep.L * ep.sync_every / chunk_med * 1e3:.1f} tokens/s "
        f"({len(chunk_ms)} chunks, first {chunk_ms[0]:.1f} ms) | batch "
        f"re-prefills {ep.batch_reprefills} | launches flash {got['flash']},"
        f" paged decode {got['paged']} = {lay} x {steps} steps | peak "
        f"{peak:.2f} GiB")
    del ep

    n_eq = min(map(len, prompts))
    equal = [p[:n_eq] for p in prompts]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = _tree_to(params, torch.float32)
    outs = {}
    for cls in (Endpoint, RestartEndpoint):
        if cls is Endpoint:
            ep = Endpoint(cfg32, max_concurrency=n, t_max=2048, page_size=16,
                          sync_every=8, params=params32, device=dev)
        else:
            ep = RestartEndpoint(cfg32, max_concurrency=n,
                                 t_max=RESTART_T_MAX, params=params32,
                                 device=dev)
        t0 = time.perf_counter()
        outs[cls.__name__], _, _, got = drive(ep, equal, H_EQUAL_NEW)
        wall = time.perf_counter() - t0
        say(f"H3 {cls.__name__} at equal prompt lengths ({n} x {n_eq}, "
            f"float32, {H_EQUAL_NEW} tokens): "
            f"{n * H_EQUAL_NEW / wall:.1f} tokens/s, batch re-prefills "
            f"{ep.batch_reprefills}, launches {got}")
        if cls is Endpoint:
            check(ep.batch_reprefills == 0 and got["dense"] == 0,
                  "H3 equal lengths: paged re-prefill or dense launch")
        else:
            check(got["dense"] == lay * H_EQUAL_NEW and got["paged"] == 0,
                  "H3 equal lengths: restart launches != one dense decode "
                  "per layer per step")
        del ep
    pg, rs = outs["Endpoint"], outs["RestartEndpoint"]
    same = [pg[i] == rs[i] for i in range(n)]
    first = [next((t for t, (a, b) in enumerate(zip(pg[i], rs[i]))
                   if a != b), None) for i in range(n)]
    del params32
    say(f"H3 paged == restart at equal prompt lengths: {sum(same)}/{n} "
        f"requests equal; first differing token per request {first}")
    check(all(same), "H3: paged and restart greedy tokens differ")
    return launches


def six_pool_phase(torch, np, dev, say, check):
    """H4: the reference's serving pool (``launch/serve.py``: H4_POOL at
    smoke size, float32, four slots each) behind ``MultiLLMServer`` with
    ``OmniRouter(RetrievalPredictor(k=8))`` over ``generate(n=600,
    seed=0)``'s training split, H4_REQS test queries of H4_NEW tokens, on
    the card and on the CPU: the same (endpoint, output) per request, no
    batch re-prefill; a recurrent endpoint refused as a speculative pair
    column on the card.  Returns the card's launches."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (BalanceAware, OmniRouter,
                                  RetrievalPredictor, RouterConfig)
    from repro_torch.core.speculative import SpecPair
    from repro_torch.data.qaserve import generate
    from repro_torch.data.tokenizer import encode_for_config
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Endpoint, MultiLLMServer, Request
    train, _, test = generate(n=600, seed=0).split()
    test = test.subset(np.arange(H4_REQS))
    cfgs = [dataclasses.replace(get_smoke_config(a), dtype=torch.float32)
            for a in H4_POOL]
    host = [_f32(build_model(c).init(i, "cpu")) for i, c in enumerate(cfgs)]
    vocab_cfg = min(cfgs, key=lambda c: c.vocab_size)
    runs, card_eps = {}, None
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        eps = [Endpoint(c, max_concurrency=4, device=where,
                        params=_tree_to(host[i], where))
               for i, c in enumerate(cfgs)]
        router = OmniRouter(RetrievalPredictor(k=8, device=where).fit(train),
                            RouterConfig(alpha=0.75))
        srv = MultiLLMServer(eps, router)
        for i in range(test.n):
            srv.submit(Request(i, encode_for_config(vocab_cfg,
                                                    test.queries[i], 32),
                               max_new=H4_NEW))
        tr_ops.launches = la_ops.launches = pd_ops.launches = 0
        fa_ops.launches = 0
        done = srv.run(lambda b: test.subset(np.array([r.rid for r in b])))
        if tag == "card":
            torch.cuda.synchronize()
            card_eps = eps
        runs[tag] = dict(
            out={r.rid: (r.endpoint, list(r.output)) for r in done},
            reprefills=sum(e.batch_reprefills for e in eps),
            per_ep=np.bincount([r.endpoint for r in done],
                               minlength=len(eps)).tolist(),
            launches=dict(vote=tr_ops.launches, dual_solve=la_ops.launches,
                          paged=pd_ops.launches, flash=fa_ops.launches))
        check(len(done) == test.n and all(
            r.done and len(r.output) == H4_NEW for r in done),
              f"H4 {tag}: not every request served")
    card, cpu = runs["card"], runs["cpu"]
    same = sum(card["out"][i] == cpu["out"][i] for i in range(test.n))
    empty = [H4_POOL[j] for j, c in enumerate(card["per_ep"]) if c == 0]
    fenced = []
    for j in (4, 5):
        try:
            MultiLLMServer(card_eps, BalanceAware(),
                           spec_pairs=(SpecPair(0, j, k=3),))
        except NotImplementedError:
            fenced.append(H4_POOL[j])
    say(f"H4 six-model pool ({', '.join(H4_POOL)} smoke, float32, "
        f"OmniRouter(RetrievalPredictor(k=8)), {test.n} requests x "
        f"{H4_NEW} tokens): card == CPU on {same}/{test.n} requests "
        f"(endpoint, output); per-endpoint requests card {card['per_ep']}, "
        f"CPU {cpu['per_ep']}"
        + (f"; the router left {', '.join(empty)} empty" if empty else "")
        + f"; batch re-prefills card {card['reprefills']}, CPU "
        f"{cpu['reprefills']}; card launches {card['launches']}, CPU "
        f"{cpu['launches']}; refused as a speculative pair column: "
        f"{fenced}")
    check(same == test.n, "H4: the card's (endpoint, output) differs from "
          "the CPU's")
    check(card["reprefills"] == 0 and cpu["reprefills"] == 0,
          "H4: batch re-prefill")
    check(all(card["launches"][k] > 0 for k in card["launches"])
          and not any(cpu["launches"].values()),
          "H4: a kernel did not launch on the card, or launched on the CPU")
    check(fenced == ["hymba-1.5b", "xlstm-350m"],
          "H4: a recurrent endpoint was accepted as a speculative column")
    return card["launches"]


def recurrent_phase(torch, np, dev, say, check):
    """Phase H: H1 (hymba-1.5b), H3 (its endpoint), H2 (xlstm-350m) and H4
    (the six-model pool).  Returns the kernels' launches and a summary."""
    launches = dict(flash=0, paged=0, dense=0, vote=0, dual_solve=0)

    def add(got):
        for key, val in got.items():
            if key in launches:
                launches[key] += val

    t0 = time.perf_counter()
    model, params, h1 = full_width_recurrent(torch, np, dev, say, check,
                                             "hymba-1.5b", 0)
    for res in h1.values():
        add(res)
    t_h1 = time.perf_counter() - t0
    add(hymba_endpoint_phase(torch, np, dev, say, check, model, params))
    del model, params
    t_h3 = time.perf_counter() - t0 - t_h1
    _, _, h2 = full_width_recurrent(torch, np, dev, say, check,
                                    "xlstm-350m", 0)
    for res in h2.values():
        check(res["flash"] == 0 and res["paged"] == 0,
              "H2: xlstm-350m launched an attention kernel")
    t_h2 = time.perf_counter() - t0 - t_h1 - t_h3
    add(six_pool_phase(torch, np, dev, say, check))
    t_h4 = time.perf_counter() - t0 - t_h1 - t_h2 - t_h3
    summary = dict(
        seconds=dict(H1=t_h1, H3=t_h3, H2=t_h2, H4=t_h4),
        prefill_ms={f"{a} {dt}": res["prefill_ms"] for a, h in (
            ("hymba-1.5b", h1), ("xlstm-350m", h2)) for dt, res in h.items()},
        decode_step_ms={f"{a} {dt}": res["step_ms"] for a, h in (
            ("hymba-1.5b", h1), ("xlstm-350m", h2)) for dt, res in h.items()},
        rel={f"{a} {dt}": (res["rel"], res["agree"]) for a, h in (
            ("hymba-1.5b", h1), ("xlstm-350m", h2)) for dt, res in h.items()},
        launches=launches)
    say(f"phase H seconds: H1 {t_h1:.1f}, H3 {t_h3:.1f}, H2 {t_h2:.1f}, "
        f"H4 {t_h4:.1f}")
    return launches, summary


# -- phase M: the MoE family; phase X: the encoder-decoder ---------------------
# M1: dbrx-132b at full width, depth cut from 40 to M1_LAYERS (float32 and
# bf16 side by side: 31.0 + 15.5 GB of weights); prompts of 1,000 and 1,537
M1_LAYERS = 2
M1_PROMPTS = (1000, 1537)
M_CHECK_STEPS = 16
# M2: the same width at depth M2_LAYERS in bf16 (28.5 GB) behind a paged
# Endpoint: M2_REQS requests with prompts in S4's hymba range, M2_NEW tokens
M2_LAYERS = 4
M2_REQS, M2_NEW = 8, 64
# M3: llama4-maverick-400b-a17b at full width, depth cut from 48 to one
# period of its pattern (a dense layer, a MoE layer of 128 experts): 37.4 GB
# in bf16; float32 at this depth would not fit beside its activations
M3_LAYERS = 2
M3_PROMPTS = (300, 433, 571, 700)
M3_STEPS = 8
# X1: seamless-m4t-large-v2 at full width and depth; frames and decoder
# prompts of different lengths
X1_BATCH, X1_FRAMES, X1_PROMPT, X1_STEPS = 4, 600, 300, 16


def record_routes(torch):
    """Wrap ``moe._router_topk`` so every call's top-k expert ids (sorted
    per token) are kept.  Returns (the list of calls, a function that
    restores the router)."""
    from repro_torch.models import moe
    inner = moe._router_topk
    calls = []

    def recording(x, w, k):
        out = inner(x, w, k)
        calls.append(out[1].sort(dim=-1).values)
        return out

    moe._router_topk = recording
    return calls, lambda: setattr(moe, "_router_topk", inner)


def route_agreement(a, b):
    """The share of (token, layer) routings whose expert sets agree between
    two runs that made the same router calls."""
    same = total = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise ValueError("the two runs routed different tokens")
        same += int((x == y).all(-1).sum())
        total += x.shape[0]
    return same / max(total, 1), total


def cut_config(name, n_layers, say, tag):
    """The published config at full width with its depth cut (printed)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    say(f"{tag}: {name} depth cut from {cfg.n_layers} to {n_layers} layers "
        "(the card's 80 GB); every width as published")
    return dataclasses.replace(cfg, n_layers=n_layers)


def dbrx_check(torch, np, dev, say, check):
    """M1: dbrx-132b at full width, depth M1_LAYERS, attention at unit-std
    scores (``_unit_fan_in``): prompts prefilled alone into pages, then
    M_CHECK_STEPS teacher-forced steps through ``decode_step_paged`` (the
    batch) and, each prompt alone, through both ``decode_step_paged`` and
    the dense ``decode_step``.  float32: the batched paged and the dense
    decode within FULL_LIMITS["float32"] of the full-sequence logits.
    bf16: both held to that float32 full sequence by H1's rule
    (TRUTH_FACTOR times the bf16 full sequence's own gaps), and each
    prompt's paged decode equal to its dense decode bit for bit.  Prints
    the share of (token, layer) whose top-k expert set in bf16 equals the
    one in float32 over every router call of the two runs."""
    import dataclasses
    from repro_torch.models import build_model
    cfg = cut_config("dbrx-132b", M1_LAYERS, say, "M1 dbrx-check")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _unit_fan_in(model.init(0, dev))
    params32 = _tree_to(params, torch.float32)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    say(f"M1 dbrx-132b: {cfg.n_layers} layers d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} ff={cfg.d_ff} "
        f"experts {cfg.n_experts} top-{cfg.top_k} V={cfg.vocab_size}; "
        f"{n_par / 1e9:.3f} B params drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    res, routes = {}, {}

    def run(tag, m, p, **kw):
        calls, restore = record_routes(torch)
        try:
            res[tag] = full_width_check(
                torch, np, m, p, dev, say, check, f"{tag}, unit-std scores",
                plens=M1_PROMPTS, steps=M_CHECK_STEPS, dense=True,
                dense_steps=M_CHECK_STEPS, **kw)
        finally:
            restore()
        routes[tag] = calls

    run("float32", model32, params32, limits=FULL_LIMITS["float32"])
    del params32
    run("bf16", model, params, truth=res["float32"]["ref"])
    f32, b16 = res["float32"], res["bf16"]
    lim = FULL_LIMITS["float32"]
    dense32 = logit_gaps(f32["alone"]["dense"], f32["ref"])
    say(f"  M1 float32 dense decode_step vs the full sequence: "
        f"max|diff|/max|logit| = {dense32[0]:.4g}, argmax agreement "
        f"{dense32[2]:.4f} (limits: <= {lim[0]}, >= {lim[1]})")
    check(dense32[0] <= lim[0] and dense32[2] >= lim[1],
          "M1 float32: the dense decode disagrees with the full sequence")
    truth = f32["ref"]
    dense16, full16 = (logit_gaps(b16["alone"]["dense"], truth),
                       logit_gaps(b16["ref"], truth))
    say(f"  M1 bf16 dense decode_step against the float32 full sequence "
        f"(max, rms relative; argmax agreement): {dense16[0]:.4g}, "
        f"{dense16[1]:.4g}; {dense16[2]:.4f}, bf16 full sequence "
        f"{full16[0]:.4g}, {full16[1]:.4g}; {full16[2]:.4f}")
    share, n_routed = route_agreement(routes["float32"], routes["bf16"])
    say(f"  M1 top-{cfg.top_k} expert sets equal in bf16 and float32 on "
        f"{share:.4f} of {n_routed} (token, layer) routings")
    check(dense16[0] <= TRUTH_FACTOR * full16[0]
          and dense16[1] <= TRUTH_FACTOR * full16[1],
          "M1 bf16: the dense decode is farther from the float32 logits "
          "than the full sequence")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"M1 peak device memory {peak:.2f} GiB")
    del params, model, model32, routes
    return dict(flash=f32["flash"] + b16["flash"],
                paged=f32["paged"] + b16["paged"],
                dense=f32["dense"] + b16["dense"],
                rel=dict(float32=(f32["rel"], f32["agree"]),
                         bf16_vs_f32=b16["decode_vs_f32"],
                         bf16_full_vs_f32=b16["full_vs_f32"]),
                expert_share=share, peak_gib=peak,
                prefill_ms={t: r["prefill_ms"] for t, r in res.items()},
                step_ms={t: r["step_ms"] for t, r in res.items()})


def dbrx_endpoint(torch, np, dev, say, check):
    """M2: dbrx-132b at full width, depth M2_LAYERS, bf16, behind a paged
    ``Endpoint`` (L M2_REQS, t_max 2,048, page 16): M2_REQS prompts of
    H_PROMPT_LO..H_PROMPT_HI tokens, M2_NEW tokens each.  0 batch
    re-prefills, one flash launch per layer per admission and one paged
    decode launch per layer per step."""
    from repro_torch.serving.engine import Endpoint
    cfg = cut_config("dbrx-132b", M2_LAYERS, say, "M2 endpoint-dbrx-8x64")
    torch.cuda.reset_peak_memory_stats()
    ep = Endpoint(cfg, max_concurrency=M2_REQS, t_max=2048, page_size=16,
                  sync_every=8, seed=0, device=dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, (int(rng.randint(
        H_PROMPT_LO, H_PROMPT_HI + 1)),)).astype(np.int32)
        for _ in range(M2_REQS)]
    _, pre_ms, chunk_ms, got = drive_endpoint(torch, ep, prompts, M2_NEW,
                                              check, "M2")
    steps = ep.busy_steps * ep.sync_every
    lay = cfg.n_layers
    check(ep.batch_reprefills == 0, "M2: batch re-prefill")
    check(len(ep.alloc.free_pages) == ep.alloc.n_pages - 1
          and len(ep.alloc.free_slots) == ep.L, "M2: allocator leak")
    check(got["paged"] > 0 and got["paged"] == lay * steps
          and got["flash"] == lay * M2_REQS and got["dense"] == 0,
          "M2: launches != one flash per layer per admission and one paged "
          "decode per layer per step")
    steady = chunk_ms[1:] or chunk_ms
    chunk_med = float(np.median(steady))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tps = ep.L * ep.sync_every / chunk_med * 1e3
    say(f"M2 endpoint (dbrx-132b full width, {lay} layers, bf16, "
        f"L={ep.L}, t_max={ep.t_max}, PS=16, sync_every=8, "
        f"{ep.alloc.n_pages} pages): {M2_REQS} requests, prompts "
        f"{min(map(len, prompts))}..{max(map(len, prompts))}, {M2_NEW} "
        f"tokens each | admission prefill {np.median(pre_ms):.1f}"
        f" ms median ({min(pre_ms):.1f}..{max(pre_ms):.1f}) | decode chunk "
        f"{chunk_med:.1f} ms median = {chunk_med / ep.sync_every:.2f} ms a "
        f"step, {tps:.1f} tokens/s ({len(chunk_ms)} chunks, first "
        f"{chunk_ms[0]:.1f} ms) | batch re-prefills {ep.batch_reprefills} "
        f"| launches flash {got['flash']}, paged decode {got['paged']} = "
        f"{lay} x {steps} steps | peak {peak:.2f} GiB")
    step_ms = chunk_med / ep.sync_every
    del ep
    return dict(got, tokens_per_s=tps, step_ms=step_ms,
                admission_ms=float(np.median(pre_ms)), peak_gib=peak)


def maverick_check(torch, np, dev, say, check):
    """M3: llama4-maverick-400b-a17b at full width, depth M3_LAYERS (a
    dense layer at dense_d_ff, a MoE layer of 128 experts top-1 with one
    shared expert), bf16 only, attention at unit-std scores: M3_PROMPTS
    prefilled alone (``moe_dense`` holds (E, T, ff) three times: one prompt
    at a time), M3_STEPS paged decode steps within FULL_LIMITS["bf16"] of
    the full sequence, each prompt alone paged = dense ``decode_step`` bit
    for bit, every logit finite."""
    from repro_torch.models import build_model
    cfg = cut_config("llama4-maverick-400b-a17b", M3_LAYERS, say,
                     "M3 maverick-check")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _unit_fan_in(model.init(0, dev))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    kinds = [("moe" if k.is_moe else "dense") for c, p in model.plan
             for _ in range(c) for k in p]
    say(f"M3 llama4-maverick-400b-a17b: {cfg.n_layers} layers ({kinds}) "
        f"d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} "
        f"expert ff={cfg.d_ff} dense ff={cfg.dense_d_ff} experts "
        f"{cfg.n_experts} top-{cfg.top_k} + {cfg.n_shared_experts} shared "
        f"V={cfg.vocab_size}; {n_par / 1e9:.3f} B params drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    res = full_width_check(torch, np, model, params, dev, say, check,
                           "bf16, unit-std scores",
                           limits=FULL_LIMITS["bf16"], plens=M3_PROMPTS,
                           steps=M3_STEPS, dense=True, dense_steps=M3_STEPS)
    check(all(bool(torch.isfinite(x).all())
              for x in res["alone"].values()),
          "M3: non-finite logits")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"M3 peak device memory {peak:.2f} GiB")
    del params, model
    return dict(flash=res["flash"], paged=res["paged"], dense=res["dense"],
                rel=(res["rel"], res["agree"]), peak_gib=peak,
                prefill_ms=res["prefill_ms"], step_ms=res["step_ms"])


def seamless_run(torch, model, params, toks, embeds, say, check, tag):
    """``prefill(tokens, embeds)`` over the first X1_PROMPT tokens, then
    X1_STEPS teacher-forced dense ``decode_step``s, and ``logits(tokens,
    embeds)`` over all of them.  One flash launch per encoder, decoder and
    cross-attention layer per call; one dense decode launch per decoder
    self- and cross-attention per step.  Returns (decode logits (B, steps,
    V), full-sequence logits at those positions, the prefill ms, the ms of
    a step, the launches)."""
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.zoo import pad_cache
    cfg = model.cfg
    per_call = cfg.n_enc_layers + 2 * cfg.n_layers
    # the calls by kind: encoder (non-causal, frames x frames), decoder
    # self-attention (causal), cross-attention (prompt x frames)
    kinds = []
    inner = fa_ops.flash_attention

    def tally(q, k, v, *, causal, **kw):
        kinds.append("self" if causal else
                     "enc" if q.shape[1] == k.shape[1] else "cross")
        return inner(q, k, v, causal=causal, **kw)

    want = dict(enc=cfg.n_enc_layers, self=cfg.n_layers, cross=cfg.n_layers)
    fa_ops.launches = pd_ops.dense_launches = 0
    fa_ops.flash_attention = tally
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, _ = model.prefill(params, toks[:, :X1_PROMPT], embeds)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fa_ops.flash_attention = inner
    got = {key: kinds.count(key) for key in want}
    check(fa_ops.launches == per_call and got == want,
          f"X1 {tag}: prefill flash launches {fa_ops.launches} by kind "
          f"{got} != {want}")
    cache = pad_cache(cache, X1_PROMPT + X1_STEPS)
    dec = []
    t0 = time.perf_counter()
    for t in range(X1_STEPS):
        cache, lg = model.decode_step(
            params, cache, toks[:, X1_PROMPT + t:X1_PROMPT + t + 1])
        dec.append(lg[:, :cfg.vocab_size])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / X1_STEPS
    dense = pd_ops.dense_launches
    check(dense == 2 * cfg.n_layers * X1_STEPS,
          f"X1 {tag}: dense decode launches {dense} != two per decoder "
          "layer per step")
    del cache
    fa_ops.launches = 0
    full = model.logits(params, toks, embeds)[
        :, X1_PROMPT:X1_PROMPT + X1_STEPS, :cfg.vocab_size]
    torch.cuda.synchronize()
    check(fa_ops.launches == per_call,
          f"X1 {tag}: logits flash launches {fa_ops.launches} != "
          f"{per_call}")
    dec = torch.stack(dec, dim=1)
    check(bool(torch.isfinite(dec).all() and torch.isfinite(full).all()),
          f"X1 {tag}: non-finite logits")
    return dec, full, pre_ms, step_ms, dict(flash=2 * per_call,
                                            dense=dense)


def seamless_check(torch, np, dev, say, check):
    """X1: seamless-m4t-large-v2 at full width and depth (attention and
    cross-attention at unit-std scores), B X1_BATCH of seeded normal frame
    embeddings of X1_FRAMES positions (the reference's stub frontend) and
    decoder prompts of X1_PROMPT tokens: the decode against ``logits(tokens,
    embeds)``, in float32 within FULL_LIMITS["float32"], in bf16 held to
    that float32 full sequence by H1's rule."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("seamless-m4t-large-v2")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _unit_fan_in(model.init(0, dev))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    say(f"X1 seamless-check: seamless-m4t-large-v2 full width and depth "
        f"({cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, "
        f"d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} "
        f"ff={cfg.d_ff} V={cfg.vocab_size}); {n_par / 1e9:.3f} B params "
        f"drawn on the card in {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(
        1, cfg.vocab_size, (X1_BATCH, X1_PROMPT + X1_STEPS)),
        dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    embeds = torch.randn(X1_BATCH, X1_FRAMES, cfg.d_model, generator=gen,
                         device=dev)
    model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    out, launches = {}, dict(flash=0, dense=0)
    for tag, m, p in (("float32", model32, _tree_to(params, torch.float32)),
                      ("bf16", model, params)):
        dec, full, pre_ms, step_ms, got = seamless_run(
            torch, m, p, toks, embeds, say, check, tag)
        for key in launches:
            launches[key] += got[key]
        out[tag] = dict(dec=dec, full=full, prefill_ms=pre_ms,
                        step_ms=step_ms)
        del p
    lim = FULL_LIMITS["float32"]
    truth = out["float32"]["full"]
    g32 = logit_gaps(out["float32"]["dec"], truth)
    d16 = logit_gaps(out["bf16"]["dec"], truth)
    f16 = logit_gaps(out["bf16"]["full"], truth)
    say(f"X1 decode vs logits(tokens, embeds) (B={X1_BATCH}, frames "
        f"{X1_FRAMES}, prompt {X1_PROMPT}, {X1_STEPS} teacher-forced dense "
        f"steps): float32 max|diff|/max|logit| = {g32[0]:.4g}, argmax "
        f"agreement {g32[2]:.4f} (limits: <= {lim[0]}, >= {lim[1]}); bf16 "
        f"against the float32 full sequence (max, rms relative; argmax): "
        f"decode {d16[0]:.4g}, {d16[1]:.4g}; {d16[2]:.4f}, full sequence "
        f"{f16[0]:.4g}, {f16[1]:.4g}; {f16[2]:.4f} | prefill ms "
        + ", ".join(f"{t} {o['prefill_ms']:.1f}" for t, o in out.items())
        + " | decode step ms "
        + ", ".join(f"{t} {o['step_ms']:.2f}" for t, o in out.items())
        + f" | launches {launches}")
    check(g32[0] <= lim[0] and g32[2] >= lim[1],
          "X1 float32: the decode disagrees with the full sequence")
    check(d16[0] <= TRUTH_FACTOR * f16[0] and d16[1] <= TRUTH_FACTOR * f16[1],
          "X1 bf16: the decode is farther from the float32 logits than "
          "the full sequence")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"X1 peak device memory {peak:.2f} GiB")
    del params, model, model32
    return dict(launches, paged=0, rel=dict(float32=g32, bf16=d16,
                                            bf16_full=f16),
                peak_gib=peak, prefill_ms={t: o["prefill_ms"]
                                           for t, o in out.items()},
                step_ms={t: o["step_ms"] for t, o in out.items()})


def moe_encdec_phase(torch, np, dev, say, check):
    """Phases M (M1, M2, M3) and X (X1), each model freed before the next
    is built.  Returns the kernels' launches and a summary."""
    launches = dict(flash=0, paged=0, dense=0)
    summary = {}
    for tag, fn in (("M1", dbrx_check), ("M2", dbrx_endpoint),
                    ("M3", maverick_check), ("X1", seamless_check)):
        t0 = time.perf_counter()
        res = fn(torch, np, dev, say, check)
        torch.cuda.empty_cache()
        for key in launches:
            launches[key] += res[key]
        res["seconds"] = time.perf_counter() - t0
        say(f"time: {tag} {res['seconds']:.1f} s")
        summary[tag] = res
    return launches, summary


# -- phase L: language-model training ------------------------------------------
# L1: the flash backward kernel against its plain version.  (tag, B, Sq,
# Skv, K, G, D, window, q_offset, causal, dtype); BWD_MAIN is L2's shape
# (h2o-danube-3-4b's heads over train_4k's 4,096 positions).
BWD_CASES = [
    ("danube heads, window 4096", 1, 4096, 4096, 8, 4, 120, 4096, 0, True,
     "bfloat16"),
    ("danube heads, float32", 1, 1024, 1024, 8, 4, 120, 4096, 0, True,
     "float32"),
    ("hymba heads, window 1024", 1, 1537, 1537, 5, 5, 64, 1024, 0, True,
     "bfloat16"),
    ("dbrx heads", 1, 1537, 1537, 8, 6, 128, 0, 0, True, "bfloat16"),
    ("seamless encoder, non-causal", 4, 600, 600, 16, 1, 64, 0, 0, False,
     "bfloat16"),
    ("seamless cross", 4, 300, 600, 16, 1, 64, 0, 0, False, "bfloat16"),
    # gemma3-4b's head dim 256: bf16 on the CUDA cores (the tensor-core
    # instances stop at 128)
    ("gemma3-4b heads, window 1024", 1, 1024, 1024, 4, 2, 256, 1024, 0, True,
     "bfloat16"),
]
BWD_MAIN = 0
# timed beside their bound and SDPA's backward: the main shape and dbrx's
# heads (D 128, G 6, causal)
BWD_TIMED = (BWD_MAIN, [c[0] for c in BWD_CASES].index("dbrx heads"))
# max |kernel - plain| over max |plain| of each of dq, dk, dv.  float32:
# both sum float32 products in another order.  bf16: P and dS are rounded
# to bf16 before their products, and a float32 sum in another order moves
# a rounding now and then: all but BWD_ULP_SHARE of the elements within
# one bf16 ulp of the plain version, and 1e-2 of the largest at most.
BWD_LIMITS = {"float32": 2e-5, "bfloat16": 1e-2}
BWD_ULP_SHARE = 1e-3
# head dims of the tensor-core backward instances (bf16)
BWD_TC_DIMS = (16, 64, 96, 120, 128)
# L2: h2o-danube-3-4b at full width and depth in bf16 under the
# launcher's full TrainConfig (8 microbatches, int8 moments, bf16
# accumulation, remat full): train_4k's sequence of 4,096 at a global
# batch of L2_BATCH (train_4k's 256 cut to one sequence a microbatch), the
# same batch for L2_STEPS steps; its card-against-plain check in float32 at
# L2_CHECK_LAYERS layers over one sequence of L2_CHECK_SEQ.
L2_ARCH = "h2o-danube-3-4b"
L2_BATCH, L2_SEQ, L2_STEPS = 8, 4096, 3
L2_CHECK_LAYERS, L2_CHECK_SEQ = 2, 1024
L2_CHECK_REL = 1e-4
# L3: the launcher's smoke run, checkpointed at L3_EVERY, resumed from there
L3_STEPS, L3_EVERY = 10, 5
# L4: one float32 train step card against CPU per family at smoke size
L4_ARCHS = ("h2o-danube-3-4b", "gemma3-4b", "phi-3-vision-4.2b",
            "hymba-1.5b", "xlstm-350m", "dbrx-132b", "seamless-m4t-large-v2")
L4_BATCH, L4_SEQ = 4, 64
# float32 card against CPU: 1e-5 relative; the recurrent families' stacks
# amplify float32 noise in the gradients (tests/test_torch_models.py holds
# xlstm-350m's logits to 1e-3; tests/test_torch_recurrent.py::
# test_hymba_gradients_amplify_float32_noise moves hymba's gradients by
# 8.7e-5 from a 1e-6 input perturbation, its loss by less than 1e-5): the
# grad norm and the gradient leaves of hymba-1.5b to 1e-4 and of xlstm-350m
# to 1e-3, every family's loss to 1e-5
L4_REL = 1e-5
L4_TOL = {"hymba-1.5b": 1e-4, "xlstm-350m": 1e-3}


def sdpa_bwd_ms(torch, F, say, time_ms, q, k, v, do, causal):
    """The backward of one ``scaled_dot_product_attention`` call on the
    (B, H, S, D) layout (``enable_gqa``, ``is_causal``), its forward kept
    outside the clock; None without ``enable_gqa``."""
    qd, kd, vd = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dd = do.transpose(1, 2).contiguous()
    try:
        out = F.scaled_dot_product_attention(qd, kd, vd, is_causal=causal,
                                             enable_gqa=True)
    except TypeError as exc:          # a PyTorch without enable_gqa
        say(f"  SDPA with enable_gqa unavailable: {exc}")
        return None
    return time_ms(torch, lambda: torch.autograd.grad(
        out, (qd, kd, vd), dd, retain_graph=True), 5, warm=1)


def bwd_kernel_phase(torch, np, say, check, dev, time_ms):
    """L1: the backward kernel (dq with Delta, then dk and dv) against
    ``flash_attention_bwd_ref`` on the forward kernel's own output and
    log-sum-exp, within BWD_LIMITS (bf16: and BWD_ULP_SHARE); two launches
    on the same inputs bit-identical (no atomics).  Every bf16 tensor-core
    instance's SASS holds HGMMA (wgmma) and no HMMA.  Times BWD_TIMED's
    cases beside their bound and SDPA's backward, the main one beside the
    plain version too.  Returns the kernels-line row."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    from repro_torch.analysis import kernel_work, roofline
    hgmma = sass_hmma("flash_attention_bwd", ("HGMMA",))
    hmma = sass_hmma("flash_attention_bwd", ("HMMA",))
    say(f"L1 flash backward SASS: HGMMA (wgmma) instructions per kernel "
        f"{hgmma}; HMMA (mma.sync) {hmma}")
    tc = [f for f in hgmma if "_tc_kernel" in f]
    check(len(tc) == 2 * len(BWD_TC_DIMS)
          and all(hgmma[f] > 0 and hmma[f] == 0 for f in tc),
          "L1: a tensor-core backward kernel instance has no HGMMA, or "
          "has HMMA")
    row, err_max = None, 0.0
    for i, (tag, b, s, skv, kh, g, d, window, q_off, causal, dt) in \
            enumerate(BWD_CASES):
        dtype = getattr(torch, dt)
        h = kh * g
        gen = torch.Generator(device=dev).manual_seed(60 + i)
        q, do = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(b, skv, kh, d, generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=q_off)
        out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
        got = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
        again = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        want = flash_attention_bwd_ref(q, k, v, out, do, lse, **kw)
        rels, shares = [], []
        for x, w in zip(got, want):
            x, w = x.float(), w.float()
            rels.append(float((x - w).abs().max())
                        / max(float(w.abs().max()), 1e-30))
            shares.append(float((~torch.isclose(x, w, atol=1e-6,
                                                rtol=2 ** -7)).float().mean()))
        del again, want
        ok = same and max(rels) <= BWD_LIMITS[dt] and (
            dt == "float32" or max(shares) <= BWD_ULP_SHARE)
        err_max = max(err_max, max(rels))
        elem = q.element_size()
        nbytes, nops = kernel_work.flash_backward(b, s, skv, h, kh, d, window,
                                                  q_off, elem, causal)
        bound = roofline.bound_ms(nops, nbytes, kernel_work.peak_for(elem))
        bound_by = roofline.bound_by(nops, nbytes, kernel_work.peak_for(elem))
        line = (f"L1 flash backward {tag}: B={b} S={s} Skv={skv} K={kh} "
                f"G={g} D={d} window={window} q_offset={q_off} "
                f"causal={causal} {dt} | max|kernel-plain|/max|plain| dq "
                f"{rels[0]:.3g}, dk {rels[1]:.3g}, dv {rels[2]:.3g} "
                f"(limit {BWD_LIMITS[dt]}); beyond one bf16 ulp "
                f"{max(shares):.2e} of the elements; two launches "
                f"bit-identical {same}")
        if i in BWD_TIMED:
            k_ms = time_ms(torch, lambda: flash_attention_bwd_cuda(
                q, k, v, out, do, lse, **kw), 5, warm=1)
            lib = sdpa_bwd_ms(torch, F, say, time_ms, q, k, v, do, causal)
            line += (f" | kernel {k_ms:.3f} ms, bound {bound:.4f} ms = max("
                     f"{nbytes / 1e6:.2f} MB / 3.35 TB/s, {nops / 1e9:.2f} "
                     f"GFLOP / 989 TFLOP/s bf16) -> {bound / k_ms:.2%} of "
                     f"it; SDPA backward (is_causal, enable_gqa) "
                     + (f"{lib:.3f} ms" if lib is not None else "n/a"))
        if i == BWD_MAIN:
            p_ms = time_ms(torch, lambda: flash_attention_bwd_ref(
                q, k, v, out, do, lse, **kw), 2, warm=1)
            line += f"; plain {p_ms:.3f} ms"
            row = dict(name="flash_attention_bwd", route="cuda",
                       source="src/repro_torch/csrc/flash_attention_bwd.cu",
                       replaces="src/repro/models/attention.py:62",
                       ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                       bound_by=bound_by, library_ms=lib)
        say(line)
        check(ok, f"L1 {tag}: the backward kernel disagrees with its plain "
                  "version or two launches differ")
        del q, k, v, do, out, lse, got
    row["max_abs_err"] = err_max
    return row


def _grads(torch, model, params, batch):
    """(loss, the gradient leaves) of ``model.loss`` at ``params``."""
    from repro_torch.training import tree_leaves, tree_map
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = model.loss(live, batch)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))


def plain_flash(torch):
    """Point ``ops.flash_attention``'s two CUDA wrappers at the plain
    versions (the chunked forward with its log-sum-exp, the plain
    backward).  Returns a function that puts the kernels back."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_chunked)
    saved = ops.flash_attention_cuda, ops.flash_attention_bwd_cuda
    ops.flash_attention_cuda = flash_attention_chunked
    ops.flash_attention_bwd_cuda = flash_attention_bwd_ref

    def restore():
        ops.flash_attention_cuda, ops.flash_attention_bwd_cuda = saved
    return restore


def l2_check(torch, np, dev, say, check):
    """L2's float32 check: h2o-danube-3-4b at full width, depth
    L2_CHECK_LAYERS (attention at unit-std scores), one sequence of
    L2_CHECK_SEQ: the loss and every gradient leaf through the kernels
    against the same with ``ops.flash_attention``'s wrappers pointed at the
    plain versions, within L2_CHECK_REL of each leaf's largest value."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(L2_ARCH), dtype=torch.float32,
                              n_layers=L2_CHECK_LAYERS)
    model = build_model(cfg)
    params = _unit_fan_in(_f32(model.init(0, dev)))
    raw = next(synthetic_batches(cfg, ShapeConfig("t", L2_CHECK_SEQ, 1,
                                                  "train")))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    loss_k, g_k = _grads(torch, model, params, batch)
    restore = plain_flash(torch)
    try:
        loss_p, g_p = _grads(torch, model, params, batch)
    finally:
        restore()
    l_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    g_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(g_k, g_p))
    say(f"L2 check: {L2_ARCH} full width, {L2_CHECK_LAYERS} layers, float32, "
        f"B 1 x S {L2_CHECK_SEQ}, remat {cfg.remat}: loss kernels "
        f"{float(loss_k):.6f}, plain {float(loss_p):.6f} (relative "
        f"{l_rel:.3g}); worst gradient leaf max|kernels-plain|/max|plain| "
        f"{g_rel:.3g} over {len(g_k)} leaves (limit {L2_CHECK_REL})")
    check(l_rel <= L2_CHECK_REL and g_rel <= L2_CHECK_REL,
          "L2 check: the kernels' loss or gradients disagree with the "
          "plain versions'")
    del params, g_k, g_p
    return dict(loss_rel=l_rel, grad_rel=g_rel)


def l2_run(torch, np, dev, say, check):
    """L2: h2o-danube-3-4b at full width and depth in bf16 (attention at
    unit-std scores, ``_unit_fan_in``: under the stock init the gradient
    norm grows ~10x a layer, to ~1e19 at 24 layers, next to float32's
    range), the launcher's full TrainConfig, L2_STEPS steps on one repeated
    batch of L2_BATCH x L2_SEQ: step 0's loss near the random init's (ln V
    plus half the logits' variance, 0.02² · d_model), the grad norm
    finite, the loss falling at every step, the parameters and int8
    moments moving.  Reports the step time, tokens/s, the dense floor, the
    peak memory, the flash launches a step and the backward kernels' device
    time in the last step (under ``torch.profiler``) as a share of an
    unprofiled step."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.analysis import kernel_work, profiler
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build_model
    from repro_torch.training import Trainer, tree_leaves
    cfg = get_config(L2_ARCH)
    tcfg = TrainConfig(microbatches=8, moment_dtype="int8")
    trainer = Trainer(build_model(cfg), tcfg)
    torch.cuda.reset_peak_memory_stats()
    params = _unit_fan_in(trainer.model.init(0, dev))
    state = {"params": params, "opt": trainer.opt.init(params)}
    del params
    n_par = sum(t.numel() for t in tree_leaves(state["params"]))
    raw = next(synthetic_batches(cfg, ShapeConfig("train_4k", L2_SEQ, L2_BATCH,
                                                  "train")))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    probe = tree_leaves(state["params"])[-1]
    p0 = probe.clone()
    m_probe = tree_leaves(state["opt"]["m"])[-1]
    say(f"L2 {L2_ARCH}: full width and depth ({cfg.n_layers} layers, "
        f"d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} "
        f"ff={cfg.d_ff} V={cfg.vocab_size}), {n_par / 1e9:.3f} B params "
        f"bf16, remat {cfg.remat}; microbatches {tcfg.microbatches}, "
        f"moments {tcfg.moment_dtype}, accumulation {tcfg.accum_dtype}; "
        f"batch {L2_BATCH} x {L2_SEQ} (train_4k's global batch 256 cut to "
        f"{L2_BATCH})")
    ops.launches = ops.bwd_launches = 0
    losses, norms, times = [], [], []
    for step in range(L2_STEPS):
        f0, b0 = ops.launches, ops.bwd_launches
        t0 = time.perf_counter()
        out = {}

        def run():
            out["metrics"] = trainer.train_step(state, batch)[1]

        if step == L2_STEPS - 1:
            prof = profiler.profile(run, dev)
        else:
            run()
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics = out["metrics"]
        launches_step = (ops.launches - f0, ops.bwd_launches - b0)
        if step == L2_STEPS - 1:
            prof_counts = dict(flash=launches_step[0], bwd=launches_step[1])
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        say(f"L2 step {step}: loss {losses[-1]:.4f} grad_norm "
            f"{norms[-1]:.4f} {times[-1]:.2f} s; flash launches forward "
            f"{launches_step[0]}, backward {launches_step[1]}")
    fwd, bwd = ops.launches, ops.bwd_launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = L2_BATCH * L2_SEQ
    step_s = times[1] if L2_STEPS > 2 else times[-1]
    floor_s = kernel_work.train_floor_s(n_par, tokens)
    bwd_ms, dev_ms = prof.ms("bwd_dq", "bwd_dkv"), prof.total_ms
    top = [(name[:70], ms, n) for name, ms, n in prof.top(8)]
    expect = math.log(cfg.vocab_size) + 0.5 * 0.02 ** 2 * cfg.d_model
    say(f"L2 step time {step_s:.3f} s (step 1), {tokens / step_s:.1f} "
        f"tokens/s; dense floor (6 + 2 for the remat forward) x "
        f"{n_par / 1e9:.3f} B x {tokens} = {8.0 * n_par * tokens:.4g} "
        f"operations at 989 TFLOP/s = {floor_s:.3f} s -> {floor_s / step_s:.1%}"
        f" of it; peak device memory {peak:.2f} GiB; flash launches "
        f"forward {fwd}, backward {bwd} over {L2_STEPS} steps; backward "
        f"kernels {bwd_ms:.1f} ms of the profiled step's device kernels' "
        f"{dev_ms:.1f} ms, {bwd_ms / (step_s * 1e3):.1%} of an unprofiled "
        f"step (the profiled one took {times[-1]:.2f} s); step 0 loss "
        f"{losses[0]:.4f} against the init's "
        f"{expect:.4f} (ln V {math.log(cfg.vocab_size):.4f})")
    say("L2 the profiled step's kernels by device time: " + "; ".join(
        f"{name} {ms:.1f} ms x {n}" for name, ms, n in top))
    check(fwd > 0 and bwd > 0, "L2: a flash kernel was not launched")
    check(abs(losses[0] - expect) <= 0.5, "L2: step 0's loss is not the "
          "random init's")
    check(all(math.isfinite(x) for x in norms), "L2: grad_norm")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          "L2: the loss did not fall at every step")
    check(not torch.equal(probe, p0), "L2: the parameters did not move")
    check(bool((m_probe.q != 0).any()), "L2: the int8 moments did not move")
    del state, batch, trainer
    return dict(flash=fwd, bwd=bwd, losses=losses, grad_norms=norms,
                step_s=step_s, tokens_per_s=tokens / step_s,
                floor_share=floor_s / step_s, peak_gib=peak,
                bwd_ms=bwd_ms, profiled_step_ms=times[-1] * 1e3,
                device_ms=dev_ms, params_b=n_par / 1e9,
                top_kernels=[[name, ms, n] for name, ms, n in top],
                profile=prof, profile_counts=prof_counts)


def l3_resume(torch, np, dev, say, check):
    """L3: ``repro_torch.launch.train.main`` on the card, h2o-danube-3-4b's
    smoke config for L3_STEPS steps checkpointed every L3_EVERY into a
    temporary directory, then a second directory holding only the
    L3_EVERY checkpoint resumed to L3_STEPS: the final parameters and
    optimizer state (the last checkpoints) equal bit for bit, and the
    last metrics equal.  The directories are deleted."""
    import shutil
    import tempfile
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train as launcher
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_l3_"))
    ops.launches = ops.bwd_launches = 0
    try:
        common = ["--arch", L2_ARCH, "--smoke", "--steps", str(L3_STEPS),
                  "--ckpt-every", str(L3_EVERY)]
        full = launcher.main(common + ["--ckpt-dir", str(root / "full")])
        (root / "part").mkdir()
        for ext in (".npz", ".json"):
            shutil.copy(root / "full" / f"ckpt_{L3_EVERY:08d}{ext}",
                        root / "part")
        part = launcher.main(common + ["--ckpt-dir", str(root / "part"),
                                       "--resume"])
        last = f"ckpt_{L3_STEPS:08d}.npz"
        with np.load(root / "full" / last) as a, \
                np.load(root / "part" / last) as b:
            keys = sorted(a.files)
            same = keys == sorted(b.files) and all(
                np.array_equal(a[k], b[k]) for k in keys)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fwd, bwd = ops.launches, ops.bwd_launches
    say(f"L3 launcher: {L2_ARCH} --smoke {L3_STEPS} steps, checkpoint every "
        f"{L3_EVERY}, resumed from step {L3_EVERY}: final state "
        f"({len(keys)} leaves) equal bit for bit {same}; last metrics "
        f"{full} vs {part}; flash launches forward {fwd}, backward {bwd}")
    check(same and full == part, "L3: the resumed run differs from the "
          "uninterrupted one")
    check(fwd > 0 and bwd > 0, "L3: a flash kernel was not launched")
    return dict(flash=fwd, bwd=bwd, same=same, last=full)


def l4_card_vs_cpu(torch, np, dev, say, check):
    """L4: one float32 ``Trainer.train_step`` (two microbatches, fp32
    moments and accumulation) per family at smoke size, from the same
    weights (drawn on the CPU, attention at unit-std scores) and batch, on
    the card and on the CPU: the loss within L4_REL, the grad norm and
    every gradient leaf (of the first microbatch) within L4_REL (relative
    to the leaf's largest value; L4_TOL for the recurrent families), and
    the parameters
    after the step.  AdamW's first step
    moves an element by lr · g / (|g| + eps): where |g| sits at float32
    noise the two devices may move it in opposite directions by up to
    2 lr, so the parameters are held by the share of elements within
    L4_REL of their leaf's largest value (>= 0.999)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build_model
    from repro_torch.training import Trainer, tree_leaves, tree_map
    cpu = torch.device("cpu")
    ops.launches = ops.bwd_launches = 0
    out = {}
    for arch in L4_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        tcfg = TrainConfig(microbatches=2, moment_dtype="fp32",
                           accum_dtype="fp32")
        model = build_model(cfg)
        base = _unit_fan_in(_f32(model.init(0, cpu)))
        raw = next(synthetic_batches(cfg, ShapeConfig("t", L4_SEQ, L4_BATCH,
                                                      "train")))
        res = []
        for where in (dev, cpu):
            trainer = Trainer(model, tcfg)
            params = tree_map(lambda t: t.to(where, copy=True), base)
            state = {"params": params, "opt": trainer.opt.init(params)}
            batch = {k: torch.from_numpy(v).to(where) for k, v in raw.items()}
            micro = {k: v[:L4_BATCH // 2] for k, v in batch.items()}
            _, grads = _grads(torch, model, state["params"], micro)
            _, metrics = trainer.train_step(state, batch)
            res.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                        [g.cpu() for g in grads],
                        [p.cpu() for p in tree_leaves(state["params"])]))
        (lc, nc, gc, pc), (lh, nh, gh, ph) = res
        l_rel = abs(lc - lh) / abs(lh)
        n_rel = abs(nc - nh) / abs(nh)
        g_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                    for a, b in zip(gc, gh))
        within = sum(int(((a - b).abs() <= L4_REL * b.abs().max()).sum())
                     for a, b in zip(pc, ph)) / sum(b.numel() for b in ph)
        p_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                    for a, b in zip(pc, ph))
        say(f"L4 {arch}: loss card {lc:.6f} CPU {lh:.6f} ({l_rel:.2g}), "
            f"grad_norm {nc:.6f} / {nh:.6f} ({n_rel:.2g}), worst gradient "
            f"leaf {g_rel:.2g}; parameters after the step: worst leaf "
            f"{p_rel:.2g}, share within {L4_REL} {within:.6f}")
        tol = L4_TOL.get(arch, L4_REL)
        check(l_rel <= L4_REL and n_rel <= tol and g_rel <= tol
              and within >= 0.999,
              f"L4 {arch}: the card's train step disagrees with the CPU's")
        out[arch] = dict(loss_rel=l_rel, norm_rel=n_rel, grad_rel=g_rel,
                         param_rel=p_rel, param_share=within)
    fwd, bwd = ops.launches, ops.bwd_launches
    say(f"L4 flash launches forward {fwd}, backward {bwd}")
    check(fwd > 0 and bwd > 0, "L4: a flash kernel was not launched")
    return dict(flash=fwd, bwd=bwd, archs=out)


def training_phase(torch, np, dev, say, check, time_ms):
    """Phase L: L1 (the backward kernel), L2 (the float32 check, then the
    full-width run), L3 (the launcher and resume), L4 (card against CPU).
    Returns the backward's kernels-line row, the flash launches of the
    phase's main paths (L2's run, L3, L4) and a summary."""
    summary = {}
    t0 = time.perf_counter()
    row = bwd_kernel_phase(torch, np, say, check, dev, time_ms)
    summary["L1_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary["L2_check"] = l2_check(torch, np, dev, say, check)
    torch.cuda.empty_cache()
    l2 = l2_run(torch, np, dev, say, check)
    torch.cuda.empty_cache()
    summary["L2"] = l2
    summary["L2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    l3 = l3_resume(torch, np, dev, say, check)
    summary["L3"] = l3
    summary["L3_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    l4 = l4_card_vs_cpu(torch, np, dev, say, check)
    summary["L4"] = l4
    summary["L4_s"] = time.perf_counter() - t0
    launches = dict(flash=l2["flash"] + l3["flash"] + l4["flash"],
                    bwd=l2["bwd"] + l3["bwd"] + l4["bwd"])
    row["launches"] = launches["bwd"]
    return row, launches, summary


# -- phase N: the serving launcher at full width, the analysis plane ----------

# N1: the launcher's pool with every member that fits one card at full width
# (29.4 B parameters, ~58.9 GB in bf16); qwen2-72b (72.7 B, 145 GB in bf16)
# stays at smoke size
N1_FULL = ("h2o-danube-3-4b", "internlm2-20b", "gemma3-4b", "hymba-1.5b",
           "xlstm-350m")
N1_ARGS = ["--requests", "24", "--max-new", "8"]
N1_STREAM = ["--arrival", "poisson", "--arrival-rate", "4", "--stream"]
# N2: one decode chunk of N1's danube endpoint (its seed, slots and t_max)
N2_ARCH = "h2o-danube-3-4b"


def _free_card(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _launch_counts():
    """The ops counters of the kernels the launcher's path runs."""
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    return dict(vote=tr_ops.launches, dual_solve=la_ops.launches,
                blocked=la_ops.blocked_launches, paged=pd_ops.launches,
                flash=fa_ops.launches)


def _zero_counts():
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    tr_ops.launches = la_ops.launches = la_ops.blocked_launches = 0
    pd_ops.launches = fa_ops.launches = 0


def launcher_phase(torch, np, dev, say, check):
    """N1: ``repro_torch.launch.serve.main`` on the card in batching mode,
    N1_ARGS, with N1_FULL at full width and depth in bf16 behind
    ``OmniRouter(RetrievalPredictor(k=8))``: every request served once, no
    batch re-prefill, the vote, dual solve, paged decode and flash kernels
    launched, and each request's endpoint that of the same launcher's route
    on the CPU (the reference's pool at smoke size: the route does not
    depend on the weights, since no request stops early); then the same
    pool under Poisson arrivals with the streaming dual: every request
    served over more than one window, with dual iterations.  Prints the
    peak device memory, each run's wall time and route overhead.  Returns
    the card's launches and a summary."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.zoo import param_count_estimate
    sizes = {a: param_count_estimate(get_config(a)) for a in serve.POOL_ARCHS}
    n_full = sum(sizes[a] for a in N1_FULL)
    left = [a for a in serve.POOL_ARCHS if a not in N1_FULL]
    say(f"N1 the launcher's pool: {', '.join(N1_FULL)} at full width and "
        f"depth ({n_full / 1e9:.1f} B parameters, {2 * n_full / 1e9:.1f} GB "
        f"in bf16); " + "; ".join(
            f"{a} at smoke size: its {sizes[a] / 1e9:.1f} B parameters "
            f"({2 * sizes[a] / 1e9:.0f} GB in bf16) do not fit one 80 GB "
            f"card" for a in left))
    t0 = time.perf_counter()
    cpu = serve.main(N1_ARGS + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    full = ["--full", ",".join(N1_FULL), "--device", str(dev)]
    runs, launches = {}, dict(vote=0, dual_solve=0, blocked=0, paged=0,
                              flash=0)
    for tag, extra in (("batching", []), ("stream", N1_STREAM)):
        _free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        res = serve.main(N1_ARGS + extra + full)
        took = time.perf_counter() - t0
        counts = _launch_counts()
        for key in launches:
            launches[key] += counts[key]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _free_card(torch)
        left_gib = torch.cuda.memory_allocated() / 2 ** 30
        say(f"N1 {tag}: served {res['served']}/{res['n']}, SR "
            f"{res['sr']:.3f}, ${res['cost']:.4f}; serve wall "
            f"{res['wall_s']:.2f} s (main {took:.1f} s with the pool's "
            f"build), route overhead {res['route_seconds']:.3f} s over "
            f"{res['windows']} windows, {res['dual_iters']} dual iters; "
            f"peak device memory {peak:.2f} GiB ({left_gib:.2f} GiB left "
            f"after); launches {counts}")
        runs[tag] = dict(
            {k: res[k] for k in ("served", "n", "sr", "cost", "wall_s",
                                 "route_seconds", "windows", "dual_iters",
                                 "endpoint")},
            reprefills=[e["reprefills"] for e in res["endpoints"]],
            reqs=[e["reqs"] for e in res["endpoints"]],
            main_s=took, peak_gib=peak, launches=counts)
        check(res["served"] == res["n"] == 24
              and res["rids"] == list(range(24)),
              f"N1 {tag}: not every request served once")
        check(all(e["reprefills"] == 0 for e in res["endpoints"]),
              f"N1 {tag}: batch re-prefill")
    bat, stream = runs["batching"], runs["stream"]
    same = sum(a == b for a, b in zip(bat["endpoint"], cpu["endpoint"]))
    say(f"N1 route: card (full-width pool) and CPU (smoke pool, {cpu_s:.1f}"
        f" s) agree on {same}/{len(cpu['endpoint'])} requests' endpoints; "
        f"per-endpoint requests card {bat['reqs']}, CPU "
        f"{[e['reqs'] for e in cpu['endpoints']]}")
    check(all(bat["launches"][k] > 0
              for k in ("vote", "dual_solve", "paged", "flash")),
          "N1: the vote, dual solve, paged decode or flash kernel did not "
          "launch")
    check(bat["endpoint"] == cpu["endpoint"],
          "N1: a request's endpoint differs from the CPU route")
    check(stream["windows"] > 1 and stream["dual_iters"] > 0,
          "N1 stream: one window or no dual iteration")
    return launches, dict(runs=runs, cpu_s=cpu_s, full=list(N1_FULL),
                          params_b=n_full / 1e9)


def analysis_phase(torch, np, dev, say, check, l2):
    """N2: the analysis plane on the card.  L2's profiled train step and one
    decode chunk of N1's danube endpoint (N1's prompts, its four slots),
    each read by ``analysis.profiler``: every hand kernel's launches by
    name equal its ``ops`` counter over the same window times the device
    kernels one launch makes (flash forward 1; flash backward 2, dq and
    dk/dv; paged decode 2, split and merge), and each window's busy share
    is printed; ``analysis.analytic.memory_term``'s bytes and floor for
    danube at the chunk's decode shape and at L2's train shape, beside the
    measured ms."""
    from repro_torch.analysis import analytic, profiler
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.qaserve import generate
    from repro_torch.data.tokenizer import encode_for_config
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.kernels.decode_attention import ops as pd_ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import zoo
    from repro_torch.serving.engine import Endpoint, Request
    out = {}
    # L2's profiled step (phase L): flash forward and backward by name
    prof, counts = l2["profile"], l2["profile_counts"]
    named = dict(flash=prof.launches("flash_tc_kernel", "flash_kernel"),
                 bwd_dq=prof.launches("bwd_dq"),
                 bwd_dkv=prof.launches("bwd_dkv"))
    say(f"N2 L2's profiled step: launches by name {named}, ops counters "
        f"{counts}; device busy {prof.busy_ms:.1f} of {prof.wall_ms:.1f} ms"
        f" = {prof.busy_share:.1%}; kernels' device ms {prof.total_ms:.1f}")
    check(named["flash"] == counts["flash"] > 0
          and named["bwd_dq"] == named["bwd_dkv"] == counts["bwd"] > 0,
          "N2: L2's launches by name differ from the ops counters")
    out["L2"] = dict(named=named, counts=counts, busy_share=prof.busy_share,
                     wall_ms=prof.wall_ms, device_ms=prof.total_ms)
    # one decode chunk of N1's danube endpoint
    cfg = get_config(N2_ARCH)
    j = serve.POOL_ARCHS.index(N2_ARCH)
    ep = Endpoint(cfg, max_concurrency=4, seed=j, device=dev)
    _, _, test = generate(n=600, seed=0).split()
    # the launcher's rule: tokens in the pool's smallest vocabulary
    vocab_cfg = min((get_config(a) if a in N1_FULL else get_smoke_config(a)
                     for a in serve.POOL_ARCHS), key=lambda c: c.vocab_size)
    for i in range(ep.L):
        ep.admit(Request(rid=i, tokens=encode_for_config(
            vocab_cfg, test.queries[i], 32), max_new=8))
    torch.cuda.synchronize()
    pd_ops.launches = 0
    done = []
    chunk = profiler.profile(lambda: done.extend(ep.step()), dev)
    n_paged = pd_ops.launches
    named = dict(split=chunk.launches("split_kernel"),
                 merge=chunk.launches("merge_kernel"))
    step_ms = chunk.wall_ms / ep.sync_every
    say(f"N2 danube decode chunk ({ep.L} slots, {ep.sync_every} steps, "
        f"{cfg.n_layers} layers): paged decode ops counter {n_paged}, by "
        f"name {named}; device busy {chunk.busy_ms:.2f} of "
        f"{chunk.wall_ms:.2f} ms = {chunk.busy_share:.1%}; top kernels "
        + "; ".join(f"{name[:48]} {ms:.2f} ms x {n}"
                    for name, ms, n in chunk.top(5)))
    check(len(done) == ep.L, "N2: the chunk did not finish its requests")
    check(named["split"] == named["merge"] == n_paged
          == ep.sync_every * cfg.n_layers,
          "N2: the chunk's paged decode launches by name differ from the "
          "ops counter")
    # the per-device terms on a one-device mesh: the bytes on one card
    one = Mesh((1, 1), ("data", "model"))
    decode = ShapeConfig("n1_decode", ep.t_max, ep.L, "decode")
    rules_d = rules_for(cfg, one, "decode", global_batch=ep.L)
    cache = zoo.input_shapes(cfg, decode)["cache"]
    mem_d = analytic.memory_term(cfg, decode, one, rules_d, ep.model.decls(),
                                 cache, zoo.cache_specs(cache, rules_d))
    train = ShapeConfig("l2_train", L2_SEQ, L2_BATCH, "train")
    mem_t = analytic.memory_term(cfg, train, one,
                                 rules_for(cfg, one, "train"),
                                 ep.model.decls(),
                                 tcfg=TrainConfig(microbatches=8,
                                                  moment_dtype="int8"))
    say(f"N2 analytic HBM model, {N2_ARCH}: decode (B {ep.L}, T "
        f"{ep.t_max}) {mem_d['memory_bytes_pd'] / 1e9:.3f} GB (params "
        f"{mem_d['params_bytes_pd'] / 1e9:.3f}, cache "
        f"{mem_d['cache_bytes_pd'] / 1e6:.2f} MB) -> floor "
        f"{mem_d['memory_s'] * 1e3:.3f} ms a step against {step_ms:.2f} ms "
        f"measured ({mem_d['memory_s'] * 1e3 / step_ms:.1%}); train (B "
        f"{L2_BATCH} x {L2_SEQ}, 8 microbatches, int8 moments) "
        f"{mem_t['memory_bytes_pd'] / 1e9:.1f} GB -> floor "
        f"{mem_t['memory_s'] * 1e3:.1f} ms a step against "
        f"{l2['step_s'] * 1e3:.1f} ms measured "
        f"({mem_t['memory_s'] / l2['step_s']:.1%})")
    out["chunk"] = dict(named=named, paged=n_paged,
                        busy_share=chunk.busy_share, wall_ms=chunk.wall_ms,
                        step_ms=step_ms, device_ms=chunk.total_ms)
    out["memory"] = dict(decode=mem_d, train=mem_t)
    del ep
    _free_card(torch)
    return n_paged, out


def serve_analysis_phase(torch, np, dev, say, check, l2):
    """Phase N: N1 (the launcher at full width) and N2 (the analysis
    plane).  Returns the launches of the kernels and a summary."""
    t0 = time.perf_counter()
    launches, n1 = launcher_phase(torch, np, dev, say, check)
    n2_paged, n2 = analysis_phase(torch, np, dev, say, check, l2)
    launches["paged"] += n2_paged
    took = time.perf_counter() - t0
    say(f"phase N: {took:.1f} s")
    return launches, dict(N1=n1, N2=n2, seconds=took)


# -- phase Q: distribution on torch.distributed, four ranks on one card -------

# Four ranks share cuda:0 and talk over gloo, every collective staged
# through host memory (NCCL refuses two ranks on one card): the phase
# proves the distributed semantics on the card and measures no multi-card
# speed.  One group of ranks (run_ranks) runs Q1-Q4; the parent then runs
# the one-rank yardsticks.
Q_RANKS = 4
Q_TIMEOUT = 600.0       # the rank group's limit (it takes well under 90 s)
Q1_SHARDS = 16          # four local shards a rank at N 16,384
Q1_ITERS = 150          # the streaming solver of RouterConfig
Q1_LR = 3.0
Q1_STALL = 0.01
Q1_ALPHA = 0.75
Q1_WINDOW = 4_096       # the warm stream's windows (three)
Q1_REPS = 5             # timed cold solves
Q2_N = 8_500            # generate(n, seed=0).split(0.5, 0.0): 4,250 to route
Q2_WINDOWS = (37, 53, 30, 4_096)
Q2_SHARDS = 4
Q2_FIT_STEPS = 40
Q3_ARCH = "dbrx-132b"   # d 6,144, d_ff 10,752, 16 experts, top-4, bf16
Q3_TOKENS = 2_048
Q3_SHAPES = ((2, 2), (4, 1))    # (data, model)
Q3_CFS = (8.0, 1.0)
Q3_SEED = 5
# moe_ep against moe_dense in bf16: the expert products tile other token
# groups (another cuBLAS kernel, so a bf16-rounded h, u or y can move by an
# ulp), and over (data 2 x model 2) each half of d_ff is combined and
# rounded to bf16 before the model all-reduce adds the halves in bf16: a
# few bf16 roundings (2**-9 each) of the largest output
Q3_TOL = 2.0 ** -6
Q4_NUMEL = 16 * 2 ** 20
Q4_STEPS = 3
Q4_STAGES, Q4_MICRO, Q4_MB, Q4_WIDTH = 4, 8, 256, 1_024
Q4_PIPE_TOL = 1e-5
# Q5: the FSDP x TP train step of h2o-danube-3-4b at full width (d 3,840,
# 32 / 8 heads of 120, d_ff 10,240, vocabulary 32,000), its depth cut to
# Q5_LAYERS, in float32 (the float32 configuration's bf16 init cast, as the
# reference's mesh test casts its own), microbatches 2, fp32 moments and
# accumulation, remat as published (full), on mesh (data 2 x model 2),
# hoist_gather off and on; held to the one-rank Trainer.train_step on the
# card with the reference test's bounds (loss 1e-4; parameters 2.5 x
# 3e-4: step-1 Adam moves a coordinate by about lr x sign(g), so that bound
# alone would pass any gradient).  The gradient itself is held through the
# moments it leaves (m = 0.1 x clip x g, v) and its norm.  Under this
# config's random init the softmax is nearly an argmax (see the serving
# plane's note), so the gradient moves far more than a rounding: the step
# is run a second time on one rank from the state moved by at most one ulp
# a coordinate, and that floor sets the bound.  Each leaf's moment blocks
# on each rank lie within Q5_FLOOR_X times the floor's distance from the
# one-rank step's (in the norm over the block), where that distance is at
# least the floor's relative distance over all the rank's blocks times
# the leaf's norm (one sample of the floor is noisy on a small leaf), and
# never tighter than Q5_MOMENT_TOL of the leaf's norm; the gradient norm
# within Q5_FLOOR_X times the floor's relative distance of m, or
# Q5_NORM_TOL.
# A zeroed, halved, sign-flipped or unreduced gradient lies at 50-200% of
# the norm, the floor at well under 1%.
Q5_ARCH, Q5_LAYERS, Q5_MESH = "h2o-danube-3-4b", 2, (2, 2)
Q5_BATCH, Q5_SEQ, Q5_MICRO, Q5_SEED = 4, 512, 2, 11
Q5_LOSS_TOL, Q5_PARAM_TOL = 1e-4, 2.5 * 3e-4
Q5_FLOOR_X, Q5_NORM_TOL, Q5_MOMENT_TOL = 4.0, 1e-4, 1e-4
# Q6: the sequence-sharded decode at danube's heads (K 8, G 4, D 120), B 2,
# T 8,192 over the four ranks, pos inside rank 2's slice (rank 3's fully
# masked): float32 within Q6_TOL of the one-rank dense decode kernel, bf16
# within one bf16 ulp; the partials entry held to its plain version; the
# reference test's 8-slice case (B 1, T 2,048, H 4, K 2, D 64, pos 1,800)
Q6_B, Q6_T, Q6_K, Q6_G, Q6_D = 2, 8_192, 8, 4, 120
Q6_POS = (4_096 + 1_000, 4_096 + 1_537)
Q6_TOL = 2e-5
Q6_REF = (1, 2_048, 4, 2, 64, 1_800, 8)     # B, T, H, K, D, pos, slices
# Q7: the elastic re-mesh.  Q5's step (danube at full width, float32, fp32
# moments and accumulation, hoist_gather on) at depth Q7_LAYERS on mesh
# (data 2 x model 2) leaves its sharded state (4.8 GB whole; int8 moments
# would halve it, but a step from int8 moments moves a coordinate whose v
# rounds to 0 by lr x m / eps, so Q5's parameter bound cannot hold);
# Checkpointer.save(specs=, mesh=) gathers it on rank 0's host, which
# writes it; each rank checks the
# file's blocks against its own (2 x 2) blocks, restores it under (1 x 4)
# and checks its blocks against local_block of the whole, bit for bit; then
# one sharded step on (1 x 4) from the restored state, held to the one-rank
# step from the saved state with Q5's bounds and moment checks (the one-ulp
# floor measured the same way) and the gradient norm within Q5_FLOOR_X
# times the floor's own move of the norm (never under Q5_NORM_TOL).
Q7_LAYERS, Q7_BATCH, Q7_SEQ, Q7_MICRO, Q7_SEED = 1, 2, 512, 1, 17
Q7_SAVE, Q7_LOAD = (2, 2), (1, 4)
# Q8: the MoE family's sharded step, dbrx-132b at full width (d 6,144, 48 /
# 8 heads of 128, 16 experts top-4, d_ff 10,752, vocabulary 100,352), its
# depth cut from 40 to Q8_LAYERS and capacity_factor set to 8.0 (no copy
# drops, as the reference's own EP test sets it), on mesh (data 2 x model
# 2) under dbrx's own train policy (the reference's dryrun.tcfg_for: int8
# moments, bf16 accumulation, hoist_gather on, as n_experts > 0), bf16
# parameters as declared, remat as published (full).  The one-rank step
# (~30 GB) runs once, in a process of its own, before the rank group: it
# keeps on the host its loss, gradient norm, both moments and, for each
# rank's blocks, the one-ulp floor (the one-rank step again from the state
# moved by at most one bf16 ulp a coordinate), writes the moments to a
# file and frees the card.  Each rank holds its sharded step to it: the
# loss within Q8_LOSS_TOL relative, the gradient norm within Q5_FLOOR_X
# times the floor's own move of the norm (a zeroed, halved or doubled
# gradient lies at 50-100% of it, the floor at a few %), every copy kept,
# the bytes = the reckoning.  Each leaf's m and v blocks are held as Q5
# holds them, but in bf16 one ulp moves m by about its own norm, so that
# holds nothing: in bf16 the loss and the norm are Q8's checks of the
# step (the CPU rank tests hold the MoE step's moments in float32).
Q8_ARCH, Q8_LAYERS, Q8_MESH, Q8_CF = "dbrx-132b", 1, (2, 2), 8.0
Q8_BATCH, Q8_SEQ, Q8_MICRO, Q8_SEED = 2, 512, 1, 13
Q8_LOSS_TOL = 1e-4


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _q_counts():
    """(vote launches, shard-statistics launches, blocked launches)."""
    from repro_torch.kernels.lagrangian_assign import ops as la_ops
    from repro_torch.kernels.topk_retrieval import ops as tr_ops
    return (tr_ops.launches, la_ops.stats_launches, la_ops.blocked_launches)


def _cpu(info):
    return [f.cpu() for f in info]


def q1_run(torch, dev, inp):
    """Q1's solves on this process (under a query mesh: this rank's part):
    both modes, a cold solve at N 16,384 (timed ``Q1_REPS`` more times), a
    three-window warm stream and a stall exit.  Returns each call's x,
    SolveInfo (and DualState), shard-statistics and blocked launches and
    gathered bytes."""
    from repro_torch.core.optimizer import DualSolver
    from repro_torch.analysis.roofline import collective_bytes
    from repro_torch.launch import mesh as pmesh
    cost, cap = inp["cost"].to(dev), inp["cap"].to(dev)
    n, m = cost.shape
    out = {}

    def call(key, fn):
        before = _q_counts()
        pmesh.reset_collectives()
        res = fn()
        _sync(torch, dev)
        c = [a - b for a, b in zip(_q_counts(), before)]
        out[key] = dict(res, stats=c[1], blocked=c[2],
                        moved=collective_bytes())

    for mode, thr, b_stream in (("quality", Q1_ALPHA, Q1_ALPHA),
                                ("budget", inp["budget"],
                                 inp["budget"] * 3 * Q1_WINDOW / n)):
        kw = dict(mode=mode, iters=Q1_ITERS, lr_constraint=Q1_LR,
                  stall_tol=Q1_STALL, norm_grad=True, shards=Q1_SHARDS)
        solver = DualSolver(**kw)
        loads = torch.full((m,), float(int(0.3 * n)), device=dev)

        def cold():
            x, info = solver.solve(cost, cap, thr, loads)
            return dict(x=x.cpu(), info=_cpu(info))
        call((mode, "cold"), cold)
        times = []
        for _ in range(Q1_REPS):
            _sync(torch, dev)
            t0 = time.perf_counter()
            solver.solve(cost, cap, thr, loads)
            _sync(torch, dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out[(mode, "ms")] = statistics.median(times)
        state = None
        wl = torch.full((m,), float(int(0.3 * Q1_WINDOW)), device=dev)
        for w in range(3):
            rows = slice(w * Q1_WINDOW, (w + 1) * Q1_WINDOW)

            def window():
                nonlocal state
                x, info, state = solver.route_window(
                    cost[rows], cap[rows], b_stream, wl, state,
                    share=1.0 / (3 - w), polish_margin=0.03)
                return dict(x=x.cpu(), info=_cpu(info), state=_cpu(state))
            call((mode, f"window {w}"), window)
        stall = DualSolver(**dict(kw, iters=200, stall_tol=0.5,
                                  stall_patience=2))

        def stall_exit():
            x, info = stall.solve(cost, cap, thr, loads)
            return dict(x=x.cpu(), info=_cpu(info))
        call((mode, "stall"), stall_exit)
    return out


def q2_predictor(torch, dev, arrays):
    from repro_torch.convert import (predictor_params_from_numpy,
                                     vector_store_from_numpy)
    from repro_torch.core import HybridPredictor, PredictorConfig
    params, (emb, labels, size), m = arrays
    pred = HybridPredictor(PredictorConfig(n_models=m),
                           params=predictor_params_from_numpy(params, dev),
                           device=dev)
    pred.retrieval.vstore = vector_store_from_numpy(emb, labels, size, dev)
    return pred


def q2_run(torch, np, dev, arrays):
    """Q2's stream on this process: ``OmniRouter`` + ``StreamController``
    over the windows ``Q2_WINDOWS`` of the pool's test split.  Returns the
    assignments, the final DualState, ``window_multiple()`` and the
    launches (vote, shard statistics, blocked)."""
    from repro_torch.core import OmniRouter, RouterConfig
    from repro_torch.core.control import StreamController
    from repro_torch.data.qaserve import generate
    _, _, test = generate(n=Q2_N, seed=0).split(0.5, 0.0)
    router = OmniRouter(q2_predictor(torch, dev, arrays),
                        RouterConfig(alpha=0.6, iters=60, shards=Q2_SHARDS))
    ctrl = StreamController(router, horizon=sum(Q2_WINDOWS))
    before = _q_counts()
    xs, start = [], 0
    for sz in Q2_WINDOWS:
        loads = np.full(test.m, float(max(50, int(0.3 * sz))))
        xs.append(ctrl.route(test.subset(np.arange(start, start + sz)),
                             loads, np.zeros(test.m)))
        start += sz
    _sync(torch, dev)
    counts = [a - b for a, b in zip(_q_counts(), before)]
    return dict(xs=xs, state=_cpu(ctrl.state),
                mult=router.window_multiple(), launches=counts)


def q3_params(torch, dev, cfg, experts, fs):
    """One MoE layer's parameters from ``Q3_SEED``, each expert matrix
    drawn whole on its own generator (so every rank's slice is a slice of
    the one set): experts ``experts``, the d_ff slice ``fs``."""
    d, ff = cfg.d_model, cfg.d_ff

    def draw(seed, shape, fan_in):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(shape, generator=g, device=dev)
                * fan_in ** -0.5)

    base = Q3_SEED * 1000
    gate, up, down = [], [], []
    for e in experts:
        gate.append(draw(base + 3 * e, (d, ff), d)[:, fs].to(cfg.dtype))
        up.append(draw(base + 3 * e + 1, (d, ff), d)[:, fs].to(cfg.dtype))
        down.append(draw(base + 3 * e + 2, (ff, d), ff)[fs].to(cfg.dtype))
    return {"router": draw(base + 999, (d, cfg.n_experts), d),
            "w_gate": torch.stack(gate), "w_up": torch.stack(up),
            "w_down": torch.stack(down)}


def q3_tokens(torch, dev, cfg):
    g = torch.Generator(device=dev).manual_seed(Q3_SEED * 1000 + 998)
    return torch.randn((Q3_TOKENS, cfg.d_model), generator=g,
                       device=dev).to(cfg.dtype)


def q3_config(cf):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(Q3_ARCH), capacity_factor=cf)


def q3_rank(torch, dev):
    """Q3 on this rank: ``moe_ep`` over each mesh shape and capacity
    factor on this rank's slice and tokens."""
    from repro_torch.common.sharding import ShardingRules, use_mesh
    from repro_torch.analysis.roofline import collective_bytes
    from repro_torch.launch import mesh as pmesh
    from repro_torch.models import moe
    out = {}
    for shape in Q3_SHAPES:
        mesh = pmesh.make_host_mesh(*shape)
        cfg = q3_config(Q3_CFS[0])
        c = mesh.coords
        e_loc, f_loc = cfg.n_experts // shape[0], cfg.d_ff // shape[1]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        params = q3_params(
            torch, dev, cfg, range(c["data"] * e_loc, (c["data"] + 1) * e_loc),
            slice(c["model"] * f_loc, (c["model"] + 1) * f_loc))
        t_loc = Q3_TOKENS // shape[0]
        xl = q3_tokens(torch, dev, cfg)[c["data"] * t_loc:
                                        (c["data"] + 1) * t_loc]
        for cf in Q3_CFS:
            stats = {}
            with use_mesh(mesh, ShardingRules({})):
                pmesh.reset_collectives()
                _sync(torch, dev)
                t0 = time.perf_counter()
                y = moe.moe_ep(q3_config(cf), params, xl[None], stats=stats)
                _sync(torch, dev)
                ms = (time.perf_counter() - t0) * 1e3
            out[(shape, cf)] = dict(y=y[0].cpu(), keep=stats["keep"].cpu(),
                                    moved=collective_bytes(), ms=ms)
        out[(shape, "peak")] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
        del params
    return out


def q4_rank(torch, dev, rank, world):
    """Q4 on this rank: the compressed all-reduce (int8 and bf16, three
    steps with error feedback) against the plain mean of every rank's
    dequantised values, which each rank recomputes from the seeds; the
    pipeline against the sequential product."""
    from repro_torch.distributed import compression
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.analysis.roofline import collective_bytes
    from repro_torch.launch import mesh as pmesh

    def draw(seed, shape, scale=1.0):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev) * scale

    mesh = pmesh.Mesh.build((world,), ("i",))
    out = {}
    for method in ("int8", "bf16"):
        err, plain_err = None, [None] * world
        gaps, tols, same_err = [], [], True
        for step in range(Q4_STEPS):
            xs = [draw(7000 + 10 * r + step, (Q4_NUMEL,))
                  for r in range(world)]
            pmesh.reset_collectives()
            mean, err = compression.compressed_psum(
                xs[rank], mesh.group("i"), err, method=method)
            moved = collective_bytes()
            local = []
            for r in range(world):
                target = xs[r] + (0.0 if plain_err[r] is None
                                  else plain_err[r])
                if method == "bf16":
                    sent = target.to(torch.bfloat16).float()
                else:
                    q, scale = compression._quant(target)
                    sent = compression._dequant(q, scale, target.shape)
                plain_err[r] = target - sent
                local.append(sent)
            plain = local[0]
            for r in range(1, world):
                plain = plain + local[r]
            plain = plain / world
            mag = sum(v.abs() for v in local) / world
            # int8: three float32 adds on each side in another order, each
            # rounding at most 2**-24 of the four summands' total (2**-22
            # of their mean magnitude); bf16: the partial sums rounded to
            # bf16 (2**-9 each)
            tol = mag * (2.0 ** -19 if method == "int8" else 2.0 ** -6)
            gaps.append(float(((mean - plain).abs() - tol).max()))
            same_err = same_err and bool(torch.equal(err, plain_err[rank]))
        out[method] = dict(excess=max(gaps), same_err=same_err, moved=moved)
    pipe = pmesh.Mesh.build((Q4_STAGES,), ("stage",))
    ws = [draw(8000 + s, (Q4_WIDTH, Q4_WIDTH), Q4_WIDTH ** -0.5)
          for s in range(Q4_STAGES)]
    x = draw(8100, (Q4_MICRO, Q4_MB, Q4_WIDTH))
    y = pipeline_forward(pipe, lambda w, h: torch.tanh(h @ w),
                         Q4_MICRO)(ws[pipe.axis_index("stage")], x)
    h = x
    for w in ws:
        h = torch.tanh(h @ w)
    out["pipeline"] = float((y - h).abs().max())
    return out


def q5_config(torch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(Q5_ARCH), n_layers=Q5_LAYERS,
                               dtype=torch.float32)


def q5_tokens(np, cfg):
    return np.random.RandomState(Q5_SEED).randint(
        0, cfg.vocab_size, (Q5_BATCH, Q5_SEQ)).astype(np.int32)


def q5_leaf_names(tree, pre=""):
    """The leaves' paths in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in q5_leaf_names(tree[k],
                                                               f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in q5_leaf_names(v, f"{pre}/{i}")]
    return [pre]


def q5_rank(torch, np, dev, rank, world):
    """Q5 on this rank: the one-rank step on the card (every rank at once:
    a whole state each, ~11 GiB, and a process's first float32 step pays
    ~9 s of first use, which the ranks then pay side by side), then the
    one-rank step again from the state moved by at most one ulp a
    coordinate (the floor), then the sharded step with hoist_gather off
    and on from the same state; each held to the one-rank step on this
    rank's blocks (parameters and both moments)."""
    import dataclasses
    from repro_torch.analysis.roofline import (collective_bytes,
                                               sharded_train_bytes)
    from repro_torch.common import cast_tree, shard_tree
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import mesh as pmesh
    from repro_torch.models import build_model
    from repro_torch.models.zoo import input_logical
    from repro_torch.training import Trainer, tree_leaves
    from repro_torch.training.optim import tree_unflatten
    cfg = q5_config(torch)
    tcfg = TrainConfig(microbatches=Q5_MICRO, moment_dtype="fp32",
                       accum_dtype="fp32")
    tr = Trainer(build_model(cfg), tcfg)
    mesh = pmesh.make_host_mesh(*Q5_MESH)
    rules = rules_for(cfg, mesh, "train")
    specs = tr.state_specs(rules)["params"]
    batch = {"tokens": torch.from_numpy(q5_tokens(np, cfg)).to(dev)}
    local_batch = shard_tree(batch, input_logical(
        cfg, ShapeConfig("t", Q5_SEQ, Q5_BATCH, "train"), rules), mesh)

    def moment_gaps(opt, ref):
        """Per moment, per leaf: (|opt's block - ref's|, |ref's|)."""
        return {key: [(float((a.float() - b.float()).norm()),
                       float(b.float().norm()))
                      for a, b in zip(tree_leaves(opt[key]),
                                      tree_leaves(ref[key]))]
                for key in ref}

    params = cast_tree(tr.model.init(Q5_SEED, dev))
    start = shard_tree(params, specs, mesh)
    t0 = time.perf_counter()
    state, met = tr.train_step({"params": params, "opt": tr.opt.init(params)},
                               batch)
    _sync(torch, dev)
    out = {"one": {k: float(v) for k, v in met.items()},
           "one_s": time.perf_counter() - t0}
    want = shard_tree(state["params"], specs, mesh)
    def blocks(opt):
        return {key: shard_tree(opt[key], specs, mesh) for key in ("m", "v")}

    moments = blocks(state["opt"])
    del state, params
    params = cast_tree(tr.model.init(Q5_SEED, dev))
    gen = torch.Generator(device=dev).manual_seed(Q5_SEED + rank)
    for t in tree_leaves(params):
        t.mul_(1 + 2.0 ** -23 * (2 * torch.rand(
            t.shape, generator=gen, device=dev) - 1))
    state, met = tr.train_step({"params": params, "opt": tr.opt.init(params)},
                               batch)
    out["floor"] = dict(grad_norm=float(met["grad_norm"]),
                        gaps=moment_gaps(blocks(state["opt"]), moments))
    out["leaves"] = q5_leaf_names(want)
    del state, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for hoist in (False, True):
        t2 = Trainer(tr.model, dataclasses.replace(tcfg, hoist_gather=hoist))
        params = tree_unflatten(start,
                                (t.clone() for t in tree_leaves(start)))
        local = {"params": params, "opt": t2.opt.init(params)}
        step = t2.sharded_step(mesh, rules)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        fa_ops.launches = fa_ops.bwd_launches = 0
        pmesh.reset_collectives()
        _sync(torch, dev)
        t0 = time.perf_counter()
        local, met = step(local, local_batch)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        moved = collective_bytes()
        gap = max(float((a.float() - b.float()).abs().max()) for a, b in
                  zip(tree_leaves(local["params"]), tree_leaves(want)))
        reckoned = sharded_train_bytes(
            t2.model, t2.tcfg, cast_tree(t2.abstract_state()["params"]),
            rules, mesh.shape, local_batch["tokens"].shape[0], Q5_SEQ)
        out[hoist] = dict(
            metrics={k: float(v) for k, v in met.items()}, gap=gap,
            moment_gaps=moment_gaps(local["opt"], moments), moved=moved, reckoned=reckoned, wall_s=wall,
            flash=(fa_ops.launches, fa_ops.bwd_launches),
            peak=(torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0))
        del local, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def q6_inputs(torch, dev, dtype, b, t, h, kh, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    draw = [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, 1, h, d), (b, t, kh, d), (b, t, kh, d))]
    return tuple(draw)


def q6_rel_err(got, want):
    """max |got - want| over want's largest |value| (0 when empty)."""
    if want.numel() == 0:
        return 0.0
    return (float((got - want).abs().max())
            / max(float(want.abs().max()), 1e-30))


def q6_rank(torch, dev, rank, world):
    """Q6 on this rank: the sequence-sharded decode (float32, bf16) against
    the one-rank dense decode on the card, and the partials entry on this
    rank's slice against its plain version."""
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, decode_attention_partials_cuda)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_partials_ref)
    from repro_torch.launch import mesh as pmesh
    mesh = pmesh.Mesh.build((world,), ("seq",))
    t_loc = Q6_T // world
    pos = torch.tensor(Q6_POS, dtype=torch.int32, device=dev)
    lens = torch.clamp(pos - rank * t_loc, min=0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = q6_inputs(torch, dev, dtype, Q6_B, Q6_T, Q6_K * Q6_G,
                            Q6_K, Q6_D, 61)
        kl = k[:, rank * t_loc:(rank + 1) * t_loc].contiguous()
        vl = v[:, rank * t_loc:(rank + 1) * t_loc].contiguous()
        d_ops.partial_launches = 0
        pmesh.reset_collectives()
        _sync(torch, dev)
        t0 = time.perf_counter()
        got = d_ops.sharded_decode_attention(q, kl, vl, pos,
                                             offset=rank * t_loc,
                                             group=mesh.group("seq"))
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        launches = d_ops.partial_launches
        moved = pmesh.collective_stats()["all-gather"]
        # the one-rank decode and the partials entry, outside the counts
        if dev.type == "cuda":
            one = decode_attention_cuda(q, k, v, pos)
            parts = decode_attention_partials_cuda(q, kl, vl, lens)
        else:
            one = d_ops.decode_attention_ref(q, k, v, pos)
            parts = d_ops.decode_attention_partials_ref(q, kl, vl, lens)
        plain = decode_attention_partials_ref(q, kl, vl, lens)
        # o, l and the live splits' m each relative to the plain version's
        # largest; an empty split's m must be NEG_INF exactly
        live = plain[1] > -1e29
        p_err = max(q6_rel_err(parts[0], plain[0]),
                    q6_rel_err(parts[2], plain[2]),
                    q6_rel_err(parts[1][live], plain[1][live]),
                    0.0 if bool((parts[1][~live] == plain[1][~live]).all())
                    else float("inf"))
        diff = (got.float() - one.float()).abs()
        e = torch.floor(torch.log2(one.float().abs().clamp(min=2.0 ** -126)))
        out[str(dtype)] = dict(
            err=float(diff.max()), in_ulp=bool((diff <= torch.exp2(e - 7))
                                                .all()),
            partials_rel_err=p_err, launches=launches, moved=moved, wall_s=wall,
            masked=bool((parts[1] == -1e30).all()) if rank == world - 1
            else None)
    return out


def q_moment_gaps(torch, got, want):
    """Per moment, per leaf: (|got - want|, |want|) in the norm over the
    block (an int8 moment dequantized)."""
    from repro_torch.training import tree_leaves
    from repro_torch.training.optim import QTensor, dequantize

    def value(t, dev):
        if isinstance(t, QTensor):
            return dequantize(QTensor(q=t.q.to(dev), scale=t.scale.to(dev)))
        return t.to(dev).float()

    out = {}
    for key in ("m", "v"):
        out[key] = []
        for a, b in zip(tree_leaves(got[key]), tree_leaves(want[key])):
            dev = (a.q if isinstance(a, QTensor) else a).device
            va, vb = value(a, dev), value(b, dev)
            out[key].append((float((va - vb).norm()), float(vb.norm())))
    return out


def q_perturb(torch, dev, params, seed):
    """Every leaf moved by at most one ulp of its dtype a coordinate (its
    ``eps`` relative), in place (float32 arithmetic, rounded to the
    leaf's dtype): the floor's start."""
    from repro_torch.training import tree_leaves
    gen = torch.Generator(device=dev).manual_seed(seed)
    for t in tree_leaves(params):
        move = 1 + torch.finfo(t.dtype).eps * (
            2 * torch.rand(t.shape, generator=gen, device=dev) - 1)
        t.copy_((t.float() * move).to(t.dtype))


def q7_config(torch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(Q5_ARCH), n_layers=Q7_LAYERS,
                               dtype=torch.float32)


def q7_rank(torch, np, dev, rank, world, workdir):
    """Q7 on this rank: the (2 x 2) step, the save, the file's blocks
    against this rank's, the restore under (1 x 4) against local_block of
    the whole, the one-rank step and its floor from the saved state, and
    the (1 x 4) step from the restored state held to it."""
    from repro_torch.analysis.roofline import (collective_bytes,
                                               sharded_train_bytes)
    from repro_torch.common import cast_tree, shard_tree
    from repro_torch.common.params import (map_state, state_tensors,
                                           tree_bytes)
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.ft.checkpoint import Checkpointer
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import mesh as pmesh
    from repro_torch.models import build_model
    from repro_torch.models.zoo import input_logical
    from repro_torch.training import Trainer, tree_leaves
    t_all = time.perf_counter()
    cfg = q7_config(torch)
    tr = Trainer(build_model(cfg), TrainConfig(
        microbatches=Q7_MICRO, moment_dtype="fp32", accum_dtype="fp32",
        hoist_gather=True))
    tokens = np.random.RandomState(Q7_SEED).randint(
        0, cfg.vocab_size, (Q7_BATCH, Q7_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    shape = ShapeConfig("t", Q7_SEQ, Q7_BATCH, "train")

    def on(mesh_shape):
        mesh = pmesh.make_host_mesh(*mesh_shape)
        rules = rules_for(cfg, mesh, "train")
        return (mesh, rules, tr.state_specs(rules),
                shard_tree(batch, input_logical(cfg, shape, rules), mesh))

    m22, r22, s22, b22 = on(Q7_SAVE)
    params = cast_tree(tr.model.init(Q7_SEED, dev))
    local = shard_tree({"params": params, "opt": tr.opt.init(params)}, s22,
                       m22)
    del params
    local, _ = tr.sharded_step(m22, r22)(local, b22)
    _sync(torch, dev)
    out = {"first_s": time.perf_counter() - t_all}
    ck = Checkpointer(workdir)
    t0 = time.perf_counter()
    ck.save(1, local, specs=s22, mesh=m22)
    out["save_s"] = time.perf_counter() - t0
    like = map_state(lambda t: torch.empty((), dtype=t.dtype),
                 cast_tree(tr.abstract_state()))
    whole, _ = ck.restore(like)                  # the saved state, host
    out["saved_blocks_same"] = all(
        torch.equal(w, l.cpu()) for w, l in zip(
            state_tensors(shard_tree(whole, s22, m22)),
            state_tensors(local)))
    del local
    m14, r14, s14, b14 = on(Q7_LOAD)
    like_dev = map_state(lambda t: torch.empty((), dtype=t.dtype, device=dev),
                     like)
    t0 = time.perf_counter()
    restored, step_no = ck.restore(like_dev, specs=s14, mesh=m14)
    _sync(torch, dev)
    out["restore_s"] = time.perf_counter() - t0
    out["restored_blocks_same"] = step_no == 1 and all(
        torch.equal(w, r.cpu()) for w, r in zip(
            state_tensors(shard_tree(whole, s14, m14)),
            state_tensors(restored)))
    out["sizes"] = dict(whole=tree_bytes(whole), block=tree_bytes(restored))

    def one_rank(start):
        state = map_state(lambda t: t.to(dev), start)
        state, met = tr.train_step(state, batch)
        return state, {k: float(v) for k, v in met.items()}

    # the one-rank step from the saved state, and its one-ulp floor
    t0 = time.perf_counter()
    state, one = one_rank(whole)
    want = shard_tree(state, s14, m14)
    del state
    start = map_state(lambda t: t.to(dev), whole)
    q_perturb(torch, dev, start["params"], Q7_SEED + rank)
    state, floor = one_rank(start)
    floor_gaps = q_moment_gaps(torch, shard_tree(state["opt"], s14["opt"],
                                                 m14), want["opt"])
    del state, start
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["one_rank_s"] = time.perf_counter() - t0
    step = tr.sharded_step(m14, r14)
    fa_ops.launches = fa_ops.bwd_launches = 0
    pmesh.reset_collectives()
    _sync(torch, dev)
    t0 = time.perf_counter()
    restored, met = step(restored, b14)
    _sync(torch, dev)
    out.update(
        one=one, floor=dict(grad_norm=floor["grad_norm"], gaps=floor_gaps),
        metrics={k: float(v) for k, v in met.items()},
        wall_s=time.perf_counter() - t0, moved=collective_bytes(),
        reckoned=sharded_train_bytes(
            tr.model, tr.tcfg, cast_tree(tr.abstract_state()["params"]), r14,
            m14.shape, b14["tokens"].shape[0], Q7_SEQ),
        gap=max(float((a.float() - b.float()).abs().max()) for a, b in
                zip(tree_leaves(restored["params"]),
                    tree_leaves(want["params"]))),
        moment_gaps=q_moment_gaps(torch, restored["opt"], want["opt"]),
        leaves=q5_leaf_names(want["params"]),
        flash=(fa_ops.launches, fa_ops.bwd_launches), s=0.0)
    del restored, want, whole
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_all
    return out


def q8_config(torch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(Q8_ARCH), n_layers=Q8_LAYERS,
                               capacity_factor=Q8_CF)


def q8_trainer(torch):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.training import Trainer
    return Trainer(build_model(q8_config(torch)), TrainConfig(
        microbatches=Q8_MICRO, moment_dtype="int8", accum_dtype="bf16",
        hoist_gather=True))


def q8_batch(torch, np, dev, cfg):
    return {"tokens": torch.from_numpy(np.random.RandomState(Q8_SEED).randint(
        0, cfg.vocab_size, (Q8_BATCH, Q8_SEQ)).astype(np.int32)).to(dev)}


def q8_one(rank, world, device, args):
    """Q8's one-rank step, alone in its process: the step from the bf16
    init, then the floor; writes both moments (int8 values and scales) to
    ``args["path"]`` and returns the loss, the norms, the floor's gaps on
    each rank's blocks and the peak memory."""
    import numpy as np
    import torch
    from repro_torch.common.params import (local_block, map_state,
                                           spec_leaves)
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.launch.mesh import Mesh
    from repro_torch.training import tree_leaves
    from repro_torch.training.optim import QTensor, dequantize
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = device
    tr = q8_trainer(torch)
    cfg = tr.model.cfg
    batch = q8_batch(torch, np, dev, cfg)

    def run(perturb):
        params = tr.model.init(Q8_SEED, dev)
        if perturb:
            q_perturb(torch, dev, params, Q8_SEED + 1)
        state = {"params": params, "opt": tr.opt.init(params)}
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, met = tr.train_step(state, batch)
        _sync(torch, dev)
        opt = {k: state["opt"][k] for k in ("m", "v")}
        del state, params
        return opt, {k: float(v) for k, v in met.items()}, \
            time.perf_counter() - t0

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    marks = [time.perf_counter()]
    opt, met, step_s = run(False)
    host = map_state(lambda t: t.cpu(), opt)
    del opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    floor_opt, floor_met, _ = run(True)
    marks.append(time.perf_counter())
    meshes = [Mesh(Q8_MESH, ("data", "model"), rank=r)
              for r in range(Q8_MESH[0] * Q8_MESH[1])]
    specs = tr.state_specs(rules_for(cfg, meshes[0], "train"))["params"]
    # each rank's blocks of each leaf, dequantized on the card a leaf at a
    # time: (|floor - one|, |one|) in the norm over the block
    gaps = [{"m": [], "v": []} for _ in meshes]
    for key in ("m", "v"):
        for one, floor, spec in zip(tree_leaves(host[key]),
                                    tree_leaves(floor_opt[key]),
                                    spec_leaves(specs)):
            one = dequantize(QTensor(q=one.q.to(dev),
                                     scale=one.scale.to(dev)))
            floor = dequantize(floor)
            for r, m in enumerate(meshes):
                a, b = local_block(floor, spec, m), local_block(one, spec, m)
                gaps[r][key].append((float((a - b).norm()),
                                     float(b.norm())))
            del one, floor
    del floor_opt
    marks.append(time.perf_counter())
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    # raw .npy files (no archive checksum over 9 GB), read back per block
    out = Path(args["path"])
    out.mkdir(parents=True, exist_ok=True)
    for key in ("m", "v"):
        for i, t in enumerate(tree_leaves(host[key])):
            np.save(out / f"{key}{i}q.npy", t.q.numpy())
            np.save(out / f"{key}{i}s.npy", t.scale.numpy())
    marks.append(time.perf_counter())
    return dict(metrics=met, floor_grad_norm=floor_met["grad_norm"],
                floor_gaps=gaps, step_s=step_s, peak=peak,
                parts_s=dict(zip(("step", "floor", "gaps", "file"),
                                 (b - a for a, b in zip(marks, marks[1:])))))


def q8_local_params(torch, dev, model, seed, specs, mesh):
    """This rank's blocks of ``model.init(seed, dev)`` without the whole
    tree at once: each leaf drawn whole, in init's order, and cut to its
    block before the next is drawn."""
    from repro_torch.common import ParamDecl
    from repro_torch.common.params import _init_leaf, local_block
    gen = torch.Generator(device=dev).manual_seed(seed)

    def walk(decl, spec):
        if isinstance(decl, ParamDecl):
            return local_block(_init_leaf(decl, gen, dev), spec, mesh)
        if isinstance(decl, dict):
            return {k: walk(decl[k], spec[k]) for k in sorted(decl)}
        return [walk(d, s) for d, s in zip(decl, spec)]

    return walk(model.decls(), specs)


def q8_rank(torch, np, dev, rank, world, path):
    """Q8 on this rank: dbrx-132b's sharded step on (2 x 2) from this
    rank's blocks of the same init, held to the one-rank step's moments
    (read from ``path``, this rank's blocks only)."""
    from repro_torch.analysis.roofline import (collective_bytes,
                                               sharded_train_bytes)
    from repro_torch.common import shard_tree
    from repro_torch.common.params import local_block
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import mesh as pmesh
    from repro_torch.models.zoo import input_logical
    from repro_torch.training import tree_leaves
    from repro_torch.training.optim import QTensor, tree_unflatten
    t_all = time.perf_counter()
    tr = q8_trainer(torch)
    cfg = tr.model.cfg
    mesh = pmesh.make_host_mesh(*Q8_MESH)
    rules = rules_for(cfg, mesh, "train")
    specs = tr.state_specs(rules)
    params = q8_local_params(torch, dev, tr.model, Q8_SEED, specs["params"],
                             mesh)
    local = {"params": params, "opt": tr.opt.init(params)}
    lb = shard_tree(q8_batch(torch, np, dev, cfg), input_logical(
        cfg, ShapeConfig("t", Q8_SEQ, Q8_BATCH, "train"), rules), mesh)
    step = tr.sharded_step(mesh, rules)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    fa_ops.launches = fa_ops.bwd_launches = 0
    pmesh.reset_collectives()
    _sync(torch, dev)
    t0 = time.perf_counter()
    local, met = step(local, lb)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    out = dict(metrics={k: float(v) for k, v in met.items()}, wall_s=wall,
               moved=collective_bytes(),
               flash=(fa_ops.launches, fa_ops.bwd_launches),
               kept=[int(x) for x in step.moe_kept],
               peak=(torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0),
               rows=lb["tokens"].shape[0])
    out["reckoned"] = sharded_train_bytes(
        tr.model, tr.tcfg, tr.abstract_state()["params"], rules, mesh.shape,
        out["rows"], Q8_SEQ)
    # the one-rank step's moments, this rank's blocks only (mapped)
    def block(name, spec):
        whole = np.load(Path(path) / name, mmap_mode="r")
        return local_block(torch.from_numpy(whole), spec, mesh).to(dev)

    want = {}
    for key in ("m", "v"):
        blocks = [QTensor(q=block(f"{key}{i}q.npy", s.q),
                          scale=block(f"{key}{i}s.npy", s.scale))
                  for i, s in enumerate(tree_leaves(specs["opt"][key]))]
        want[key] = tree_unflatten(local["opt"][key], iter(blocks))
    out["moment_gaps"] = q_moment_gaps(torch, local["opt"], want)
    out["leaves"] = q5_leaf_names(local["params"])
    del local, want, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_all
    return out


def q_rank(rank, world, device, args):
    """Phase Q's rank body (``run_ranks`` loads it from this file): Q1 and
    Q2 under the query mesh, Q3 and Q4 on meshes of their own; one
    shard-statistics launch held against its plain version at this rank's
    shape.  Returns what the parent checks."""
    import numpy as np
    import torch
    from repro_torch.common.sharding import query_mesh, query_rules, use_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    t0 = time.perf_counter()
    with use_mesh(query_mesh(), query_rules()):
        out["q1"] = q1_run(torch, device, args["q1"])
        out["q2"] = q2_run(torch, np, device, args["q2"])
    out["q12_s"] = time.perf_counter() - t0
    if device.type == "cuda":
        from repro_torch.kernels.lagrangian_assign.kernel import (
            shard_stats_cuda)
        from repro_torch.kernels.lagrangian_assign.ref import shard_stats_ref
        rows = args["q1"]["cost"].shape[0] // world
        a = args["q1"]["cost"][rank * rows:(rank + 1) * rows].to(device)
        b = -args["q1"]["cap"][rank * rows:(rank + 1) * rows].to(device)
        lb = Q1_SHARDS // world
        nv = torch.full((lb,), float(rows // lb), device=device)
        lam, lam2 = torch.tensor(0.5, device=device), a[0] * 0.0
        got = shard_stats_cuda(a, b, lam, lam2, nv, lblocks=lb)
        want = shard_stats_ref(a, b, lam, lam2, nv, lblocks=lb)
        out["stats_err"] = float((got - want).abs().max())
        out["stats_same"] = bool(torch.equal(got, want))
    t0 = time.perf_counter()
    out["q3"] = q3_rank(torch, device)
    out["q3_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["q4"] = q4_rank(torch, device, rank, world)
    out["q4_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["q5"] = q5_rank(torch, np, device, rank, world)
    out["q5_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["q6"] = q6_rank(torch, device, rank, world)
    out["q6_s"] = time.perf_counter() - t0
    out["q7"] = q7_rank(torch, np, device, rank, world, args["q7_dir"])
    out["q8"] = q8_rank(torch, np, device, rank, world, args["q8_path"])
    return out


def q_hold(check, tag, r, got, one, floor_gaps, floor_norm, leaves, *,
           loss_rel=None):
    """Q5's checks of one rank's sharded step against the one-rank step
    (``one``) for Q7 and Q8: the loss (absolute Q5_LOSS_TOL, or relative
    ``loss_rel``), the parameters (Q5_PARAM_TOL, where the rank measured
    them), the gradient norm within Q5_FLOOR_X times the one-ulp floor's
    own relative move of the norm (never under Q5_NORM_TOL), each leaf's m
    and v blocks within Q5_FLOOR_X times the floor's distance (at least the
    rank's relative floor times the leaf's norm; never under Q5_MOMENT_TOL
    of it).  In bf16 (Q8) the floor moves m by about its own norm, so the
    moment check there is no check of the gradient: the loss and the norm
    are.  Returns (loss gap, norm gap, the floor's relative move of the
    norm, of m, the worst leaf's distance over its floor for m and v)."""
    dl = abs(got["metrics"]["loss"] - one["loss"])
    if loss_rel is not None:
        dl /= abs(one["loss"])
    dn = abs(got["metrics"]["grad_norm"] - one["grad_norm"]) \
        / one["grad_norm"]
    fn = abs(floor_norm - one["grad_norm"]) / one["grad_norm"]
    rel = {key: (sum(g * g for g, _ in floor_gaps[key])
                 / sum(n * n for _, n in floor_gaps[key])) ** 0.5
           for key in ("m", "v")}
    check(dl < (Q5_LOSS_TOL if loss_rel is None else loss_rel),
          f"{tag} rank {r}: loss {dl:.3g} from the one-rank step"
          + (" (relative)" if loss_rel is not None else ""))
    if "gap" in got:
        check(got["gap"] < Q5_PARAM_TOL, f"{tag} rank {r}: a parameter "
              f"{got['gap']:.3g} from the one-rank step")
    check(dn <= max(Q5_FLOOR_X * fn, Q5_NORM_TOL),
          f"{tag} rank {r}: gradient norm {got['metrics']['grad_norm']:.7g},"
          f" one-rank {one['grad_norm']:.7g} ({dn:.3g} relative; the one-ulp"
          f" floor moves the norm to {floor_norm:.7g}, {fn:.3g} relative)")
    ratio = {"m": 0.0, "v": 0.0}
    for key in ratio:
        for name, (gs, n), (gp, _) in zip(leaves, got["moment_gaps"][key],
                                          floor_gaps[key]):
            base = max(gp, rel[key] * n)
            ratio[key] = max(ratio[key], gs / base if base > 0 else
                             (0.0 if gs == 0 else float("inf")))
            check(gs <= max(Q5_FLOOR_X * base, Q5_MOMENT_TOL * n),
                  f"{tag} rank {r}: moment {key} of {name} {gs:.3g} from the "
                  f"one-rank step's (the one-ulp floor {gp:.3g}, over the "
                  f"rank's blocks {rel[key]:.3g} relative; its norm {n:.3g})")
    check(all(got["moved"][k] == n for k, n in got["reckoned"].items()),
          f"{tag} rank {r}: moved {got['moved']}, reckoned "
          f"{got['reckoned']}")
    return dl, dn, fn, rel["m"], ratio


def q7_report(torch, dev, say, check, ranks):
    """Q7's checks in the parent: the blocks bit for bit, the (1 x 4) step
    against the one-rank step from the saved state."""
    cfg = q7_config(torch)
    remat = 2 if cfg.remat != "none" else 1
    want_flash = (Q7_LAYERS * Q7_MICRO * remat, Q7_LAYERS * Q7_MICRO)
    gaps = dict(loss=0.0, norm=0.0, floor_norm=0.0, floor_m=0.0, m=0.0,
                v=0.0, param=0.0)
    flash = [0, 0]
    for r, rk in enumerate(ranks):
        got = rk["q7"]
        check(got["saved_blocks_same"], f"Q7 rank {r}: the saved file's "
              f"blocks under {Q7_SAVE} differ from the rank's own")
        check(got["restored_blocks_same"], f"Q7 rank {r}: the blocks "
              f"restored under {Q7_LOAD} differ from local_block of the "
              "saved state")
        dl, dn, fn, fm, ratio = q_hold(check, "Q7", r, got, got["one"],
                                       got["floor"]["gaps"],
                                       got["floor"]["grad_norm"],
                                       got["leaves"])
        for k, v in (("loss", dl), ("norm", dn), ("floor_norm", fn),
                     ("floor_m", fm),
                     ("m", ratio["m"]), ("v", ratio["v"]),
                     ("param", got["gap"])):
            gaps[k] = max(gaps[k], v)
        if dev.type == "cuda":
            check(tuple(got["flash"]) == want_flash, f"Q7 rank {r}: flash "
                  f"(forward, backward) launches {got['flash']}, want "
                  f"{want_flash}")
        flash[0] += got["flash"][0]
        flash[1] += got["flash"][1]
    med = {k: statistics.median(rk["q7"][k] for rk in ranks)
           for k in ("s", "first_s", "save_s", "restore_s", "one_rank_s",
                     "wall_s")}
    moved = ranks[0]["q7"]["moved"]
    say(f"Q7 re-mesh: {Q5_ARCH} at full width, depth cut to {Q7_LAYERS}, "
        f"float32, batch {Q7_BATCH} x {Q7_SEQ}, {Q7_MICRO} microbatch, "
        f"hoist_gather on; the state after a {Q7_SAVE} step "
        f"({ranks[0]['q7']['sizes']['whole'] / 1e9:.2f} GB whole) saved "
        f"(gathered on rank 0's host, which writes it) in "
        f"{med['save_s']:.2f} s and"
        f" restored under {Q7_LOAD} "
        f"({ranks[0]['q7']['sizes']['block'] / 1e9:.2f} GB a rank) in {med['restore_s']:.2f} s: the file's blocks = each "
        f"rank's, the restored blocks = local_block of the saved state, bit "
        f"for bit on every rank; the {Q7_LOAD} step from them: loss within "
        f"{gaps['loss']:.3g} (limit {Q5_LOSS_TOL:g}), parameters within "
        f"{gaps['param']:.3g} (limit {Q5_PARAM_TOL:.3g}), gradient norm "
        f"within {gaps['norm']:.3g} relative (limit {Q5_FLOOR_X:g} x the "
        f"one-ulp floor's move of the norm, up to {gaps['floor_norm']:.3g}; "
        f"the floor moves m by {gaps['floor_m']:.3g}), moments m, v within "
        f"{gaps['m']:.3g}, "
        f"{gaps['v']:.3g} x the floor's distance (limit {Q5_FLOOR_X:g}); "
        f"rank 0 moved {moved['all-gather']:,} bytes all-gathered, "
        f"{moved['all-reduce']:,} all-reduced = the reckoning; flash "
        f"(forward, backward) a rank {ranks[0]['q7']['flash']}; the step "
        f"{med['wall_s']:.2f} s wall (four processes time-sliced on one card "
        f"over host-staged gloo, not a multi-card time); Q7 {med['s']:.1f} s "
        f"(the {Q7_SAVE} step {med['first_s']:.1f}, the one-rank step and "
        f"its floor {med['one_rank_s']:.1f})")
    return dict(gaps, flash_launches=flash, **med,
                whole_bytes=ranks[0]["q7"]["sizes"]["whole"],
                all_gather=moved["all-gather"],
                all_reduce=moved["all-reduce"])


def q8_report(torch, dev, say, check, ranks, one):
    """Q8's checks in the parent: each rank's dbrx-132b step against the
    one-rank step's loss, norm and moments (the floor per rank's blocks),
    every copy kept, the bytes, the bf16 flash launches a rank."""
    from repro_torch.configs import get_config
    cfg = q8_config(torch)
    full = get_config(Q8_ARCH)
    remat = 2 if cfg.remat != "none" else 1
    want_flash = (Q8_LAYERS * Q8_MICRO * remat, Q8_LAYERS * Q8_MICRO)
    gaps = dict(loss=0.0, norm=0.0, floor_norm=0.0, floor_m=0.0, m=0.0,
                v=0.0)
    flash, kept, copies = [0, 0], 0, 0
    for r, rk in enumerate(ranks):
        got = rk["q8"]
        dl, dn, fn, fm, ratio = q_hold(
            check, "Q8", r, got, one["metrics"], one["floor_gaps"][r],
            one["floor_grad_norm"], got["leaves"], loss_rel=Q8_LOSS_TOL)
        for k, v in (("loss", dl), ("norm", dn), ("floor_norm", fn),
                     ("floor_m", fm),
                     ("m", ratio["m"]), ("v", ratio["v"])):
            gaps[k] = max(gaps[k], v)
        kept += got["kept"][0]
        copies += got["kept"][1]
        check(got["kept"][1] > 0 and got["kept"][0] == got["kept"][1],
              f"Q8 rank {r}: copies kept {got['kept']}")
        check(got["moved"]["all-to-all"] > 0, f"Q8 rank {r}: no token "
              "exchange")
        if dev.type == "cuda":
            check(tuple(got["flash"]) == want_flash, f"Q8 rank {r}: flash "
                  f"(forward, backward) launches {got['flash']}, want "
                  f"{want_flash}")
        flash[0] += got["flash"][0]
        flash[1] += got["flash"][1]
    wall = statistics.median(rk["q8"]["wall_s"] for rk in ranks)
    took = statistics.median(rk["q8"]["s"] for rk in ranks)
    peak = max(rk["q8"]["peak"] for rk in ranks) / 2 ** 30
    moved = ranks[0]["q8"]["moved"]
    say(f"Q8: {Q8_ARCH} at full width (d {cfg.d_model}, {cfg.n_heads} / "
        f"{cfg.n_kv_heads} heads of {cfg.hd}, {cfg.n_experts} experts top-"
        f"{cfg.top_k}, d_ff {cfg.d_ff}, vocabulary {cfg.vocab_size}); cut: "
        f"depth {full.n_layers} -> {Q8_LAYERS}, capacity_factor "
        f"{full.capacity_factor:g} -> {Q8_CF:g}; bf16 parameters, int8 "
        f"moments, bf16 accumulation, hoist_gather on, remat {cfg.remat}; "
        f"batch {Q8_BATCH} x {Q8_SEQ}, {Q8_MICRO} microbatch"
        f"{'es' if Q8_MICRO > 1 else ''}; mesh (data "
        f"{Q8_MESH[0]} x model {Q8_MESH[1]})")
    say(f"Q8: loss {ranks[0]['q8']['metrics']['loss']:.6f} against the "
        f"one-rank step's {one['metrics']['loss']:.6f} ({gaps['loss']:.3g} "
        f"relative; limit {Q8_LOSS_TOL:g}); gradient norm "
        f"{ranks[0]['q8']['metrics']['grad_norm']:.6g} against "
        f"{one['metrics']['grad_norm']:.6g} ({gaps['norm']:.3g} relative; "
        f"limit {Q5_FLOOR_X:g} x the one-ulp floor's move of the norm, to "
        f"{one['floor_grad_norm']:.6g}: {gaps['floor_norm']:.3g}); moments "
        f"m, v within {gaps['m']:.3g}, {gaps['v']:.3g} x the floor's "
        f"distance (the floor moves m by {gaps['floor_m']:.3g}, so in bf16 "
        f"that is no check of the gradient); "
        f"copies kept {kept} of {copies} ({kept / max(copies, 1):.4f}); "
        f"rank 0 moved {moved['all-gather']:,} bytes all-gathered, "
        f"{moved['reduce-scatter']:,} reduce-scattered, "
        f"{moved['all-reduce']:,} all-reduced, {moved['all-to-all']:,} "
        f"all-to-all = roofline.sharded_train_bytes on every rank; bf16 "
        f"flash (forward, backward) launches a rank "
        f"{ranks[0]['q8']['flash']}; a step {wall:.2f} s wall (median of "
        f"the ranks: four processes time-sliced on one card over "
        f"host-staged gloo, not a multi-card time), peak {peak:.2f} GiB a "
        f"rank; the one-rank step {one['step_s']:.2f} s in its own process,"
        f" peak {one['peak'] / 2 ** 30:.2f} GiB (s by part "
        + ", ".join(f"{k} {v:.1f}" for k, v in one["parts_s"].items())
        + f"); Q8 {took:.1f} s a rank")
    return dict(gaps, kept=kept, copies=copies, wall_s=wall, s=took,
                peak_gib=peak, one_rank_s=one["step_s"],
                one_rank_peak_gib=one["peak"] / 2 ** 30,
                loss=ranks[0]["q8"]["metrics"]["loss"],
                one_rank_loss=one["metrics"]["loss"],
                all_gather=moved["all-gather"],
                reduce_scatter=moved["reduce-scatter"],
                all_reduce=moved["all-reduce"],
                all_to_all=moved["all-to-all"], flash_launches=flash,
                flash_a_rank=ranks[0]["q8"]["flash"])


def q5_report(torch, dev, say, check, ranks):
    """Q5's checks in the parent: each rank's sharded step against its
    one-rank step (the gradient against the one-ulp floor), the counted
    bytes against the reckoning, the flash launches a rank."""
    from repro_torch.configs import get_config
    cfg = q5_config(torch)
    depth = get_config(Q5_ARCH).n_layers
    remat = 2 if cfg.remat != "none" else 1
    want_flash = (Q5_LAYERS * Q5_MICRO * remat, Q5_LAYERS * Q5_MICRO)
    say(f"Q5: {Q5_ARCH} at full width (d {cfg.d_model}, {cfg.n_heads} / "
        f"{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocabulary "
        f"{cfg.vocab_size}), depth cut from {depth} to {Q5_LAYERS} layers; "
        f"float32 (the bf16 init cast), batch {Q5_BATCH} x {Q5_SEQ}, "
        f"{Q5_MICRO} microbatches, fp32 moments and accumulation, remat "
        f"{cfg.remat}; mesh (data {Q5_MESH[0]} x model {Q5_MESH[1]})")
    out, flash = {}, [0, 0]
    for hoist in (False, True):
        tag = f"Q5 hoist_gather {'on' if hoist else 'off'}"
        loss_gap = gap = norm_gap = floor_rel = 0.0
        ratio = {"m": 0.0, "v": 0.0}
        for r, rk in enumerate(ranks):
            got, one = rk["q5"][hoist], rk["q5"]["one"]
            floor = rk["q5"]["floor"]
            dl = abs(got["metrics"]["loss"] - one["loss"])
            dn = (abs(got["metrics"]["grad_norm"] - one["grad_norm"])
                  / one["grad_norm"])
            # the floor's distance of each moment relative to the moment,
            # over this rank's blocks: how far a one-ulp move carries it
            rel = {key: (sum(g * g for g, _ in floor["gaps"][key])
                         / sum(n * n for _, n in floor["gaps"][key])) ** 0.5
                   for key in ratio}
            loss_gap, gap = max(loss_gap, dl), max(gap, got["gap"])
            norm_gap, floor_rel = max(norm_gap, dn), max(floor_rel, rel["m"])
            check(dl < Q5_LOSS_TOL, f"{tag} rank {r}: loss {dl:.3g} from "
                  "the one-rank step")
            check(got["gap"] < Q5_PARAM_TOL, f"{tag} rank {r}: a parameter "
                  f"{got['gap']:.3g} from the one-rank step")
            check(dn <= max(Q5_FLOOR_X * rel["m"], Q5_NORM_TOL),
                  f"{tag} rank {r}: gradient norm "
                  f"{got['metrics']['grad_norm']:.7g}, one-rank "
                  f"{one['grad_norm']:.7g} ({dn:.3g} relative; the one-ulp "
                  f"floor moves m by {rel['m']:.3g})")
            for key in ratio:
                for name, (gs, n), (gp, _) in zip(
                        rk["q5"]["leaves"], got["moment_gaps"][key],
                        floor["gaps"][key]):
                    base = max(gp, rel[key] * n)
                    ratio[key] = max(ratio[key], gs / base if base > 0 else
                                     (0.0 if gs == 0 else float("inf")))
                    check(gs <= max(Q5_FLOOR_X * base, Q5_MOMENT_TOL * n),
                          f"{tag} rank {r}: moment {key} of {name} {gs:.3g} "
                          f"from the one-rank step's (the one-ulp floor "
                          f"{gp:.3g}, over the rank's blocks {rel[key]:.3g} "
                          f"relative; its norm {n:.3g})")
            check(all(got["moved"][k] == n
                      for k, n in got["reckoned"].items()),
                  f"{tag} rank {r}: moved {got['moved']}, reckoned "
                  f"{got['reckoned']}")
            if dev.type == "cuda":
                check(tuple(got["flash"]) == want_flash,
                      f"{tag} rank {r}: flash (forward, backward) launches "
                      f"{got['flash']}, want {want_flash}")
            flash[0] += got["flash"][0]
            flash[1] += got["flash"][1]
        walls = [rk["q5"][hoist]["wall_s"] for rk in ranks]
        peak = max(rk["q5"][hoist]["peak"] for rk in ranks) / 2 ** 30
        moved = ranks[0]["q5"][hoist]["moved"]
        out["hoist" if hoist else "gather"] = dict(
            loss_gap=loss_gap, param_gap=gap, grad_norm_rel_gap=norm_gap,
            floor_m_rel=floor_rel, moment_over_floor=ratio,
            grad_norm=ranks[0]["q5"][hoist]["metrics"]["grad_norm"],
            loss=ranks[0]["q5"][hoist]["metrics"]["loss"],
            one_rank_loss=ranks[0]["q5"]["one"]["loss"],
            wall_s=statistics.median(walls), peak_gib=peak,
            all_gather=moved["all-gather"],
            reduce_scatter=moved["reduce-scatter"],
            all_reduce=moved["all-reduce"],
            flash_a_rank=ranks[0]["q5"][hoist]["flash"])
        say(f"{tag}: loss {ranks[0]['q5'][hoist]['metrics']['loss']:.6f} "
            f"({loss_gap:.3g} from the one-rank step; limit {Q5_LOSS_TOL:g}),"
            f" parameters within {gap:.3g} (limit {Q5_PARAM_TOL:.3g}), "
            f"gradient norm {ranks[0]['q5'][hoist]['metrics']['grad_norm']:.7g}"
            f" within {norm_gap:.3g} relative (limit {Q5_FLOOR_X:g} x the "
            f"one-ulp floor's {floor_rel:.3g}), each leaf's moments m, v "
            f"within {ratio['m']:.3g}, {ratio['v']:.3g} x the floor's "
            f"distance (limit {Q5_FLOOR_X:g}); rank "
            f"0 moved {moved['all-gather']:,} bytes all-gathered, "
            f"{moved['reduce-scatter']:,} reduce-scattered, "
            f"{moved['all-reduce']:,} all-reduced = roofline."
            f"sharded_train_bytes on every rank; flash (forward, backward) "
            f"launches a rank {ranks[0]['q5'][hoist]['flash']}; a step "
            f"{statistics.median(walls):.2f} s wall (median of the ranks: "
            f"four processes time-sliced on one card over host-staged "
            f"gloo, not a multi-card time), peak {peak:.2f} GiB a rank")
    out["flash_launches"] = flash
    out["one_rank_s"] = statistics.median(rk["q5"]["one_s"] for rk in ranks)
    one, floor = ranks[0]["q5"]["one"], ranks[0]["q5"]["floor"]
    out["floor_grad_norm_rel"] = (abs(floor["grad_norm"] - one["grad_norm"])
                                  / one["grad_norm"])
    say(f"Q5 floor: the one-rank step from the state moved by at most one "
        f"ulp a coordinate moves the gradient norm by "
        f"{out['floor_grad_norm_rel']:.3g} relative ({one['grad_norm']:.7g}"
        f" to {floor['grad_norm']:.7g}) and m by up to "
        f"{out['gather']['floor_m_rel']:.3g} of its norm on a rank")
    say(f"Q5 one-rank step on each rank (side by side, each its process's "
        f"first float32 step): {out['one_rank_s']:.2f} s wall")
    return out


def q6_report(torch, dev, say, check, ranks):
    """Q6's checks in the parent, and the reference test's 8-slice case in
    this process."""
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    out = {"partial_launches": 0, "partials_rel_err": 0.0}
    for dtype in ("torch.float32", "torch.bfloat16"):
        err = 0.0
        for r, rk in enumerate(ranks):
            got = rk["q6"][dtype]
            err = max(err, got["err"])
            out["partials_rel_err"] = max(out["partials_rel_err"],
                                          got["partials_rel_err"])
            out["partial_launches"] += got["launches"]
            if dtype == "torch.float32":
                check(got["err"] <= Q6_TOL, f"Q6 {dtype} rank {r}: "
                      f"{got['err']:.3g} from the one-rank decode")
            else:
                check(got["in_ulp"], f"Q6 {dtype} rank {r}: beyond one bf16"
                      " ulp of the one-rank decode")
            check(got["partials_rel_err"] <= Q6_TOL, f"Q6 {dtype} rank {r}: "
                  f"the partials entry {got['partials_rel_err']:.3g} "
                  "(relative) from its plain version")
            if dev.type == "cuda":
                check(got["launches"] == 1, f"Q6 {dtype} rank {r}: "
                      f"{got['launches']} partials launches")
        check(ranks[-1]["q6"][dtype]["masked"], f"Q6 {dtype}: the last "
              "rank's slice past pos is not all empty splits")
        out[dtype] = dict(err=err, wall_s=statistics.median(
            rk["q6"][dtype]["wall_s"] for rk in ranks),
            gathered=ranks[0]["q6"][dtype]["moved"])
        say(f"Q6 {dtype[6:]}: sequence-sharded decode (B {Q6_B}, T {Q6_T:,} "
            f"over {len(ranks)} ranks, K {Q6_K}, G {Q6_G}, D {Q6_D}, pos "
            f"{Q6_POS}) max |sharded - one-rank kernel| {err:.3g}"
            + (f" (limit {Q6_TOL:g})" if dtype == "torch.float32"
               else " (within one bf16 ulp)")
            + f"; one partials launch a rank, {out[dtype]['gathered']:,} "
            f"bytes of partials all-gathered; "
            f"{out[dtype]['wall_s'] * 1e3:.2f} ms (time-sliced)")
    b, t, h, kh, d, pos, n = Q6_REF
    q, k, v = q6_inputs(torch, dev, torch.float32, b, t, h, kh, d, 62)
    before = d_ops.partial_launches
    parts = [d_ops.decode_attention_partials(
        q, k[:, s * t // n:(s + 1) * t // n].contiguous(),
        v[:, s * t // n:(s + 1) * t // n].contiguous(),
        max(pos - s * t // n, 0)) for s in range(n)]
    out["partial_launches"] += d_ops.partial_launches - before
    o, m, l = (torch.cat([p[i] for p in parts], dim=2) for i in range(3))
    got = d_ops.merge_partials(o, m, l).reshape(b, 1, h, d)
    want = decode_attention_ref(q, k, v, torch.tensor([pos], device=dev))
    err8 = float((got - want).abs().max())
    check(err8 <= Q6_TOL, f"Q6 8-slice case: {err8:.3g} from the plain "
          "decode")
    out["eight_slice_err"] = err8
    say(f"Q6 8-slice case (B {b}, T {t:,}, H {h}, K {kh}, D {d}, pos {pos}):"
        f" partials of {n} slices merged, max |merged - plain decode| "
        f"{err8:.3g} (limit {Q6_TOL:g}); partials entry against its plain "
        f"version on every rank's slice: {out['partials_rel_err']:.3g} "
        "relative")
    return out


def _same_list(a, b) -> bool:
    return len(a) == len(b) and all(bool((x == y).all()) and
                                    x.shape == y.shape for x, y in zip(a, b))


def sharded_phase(torch, np, dev, say, check, cost, cap, budget):
    """Phase Q: four ranks on the card (``run_ranks``, gloo) run Q1 (the
    sharded solve of the 16k predictions), Q2 (the query-sharded stream),
    Q3 (``moe_ep`` at dbrx-132b's widths) and Q4 (the compressed
    all-reduce and the pipeline); the parent holds them to the one-rank
    port on the card.  Returns (the shard-statistics launches, the vote
    launches, the shard-statistics kernel's error, a summary)."""
    from repro_torch.analysis.roofline import sharded_solve_bytes
    from repro_torch.convert import predictor_params_to_numpy
    from repro_torch.core import HybridPredictor, PredictorConfig
    from repro_torch.data.qaserve import generate
    from repro_torch.kernels.lagrangian_assign.ref import loop_iterations
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import moe

    t_all = time.perf_counter()
    train, _, _ = generate(n=Q2_N, seed=0).split(0.5, 0.0)
    pred = HybridPredictor(PredictorConfig(n_models=train.m), device=dev
                           ).fit(train, steps=Q2_FIT_STEPS)
    vs = pred.retrieval.vstore
    q2_arrays = (predictor_params_to_numpy(pred.trained.params),
                 (vs.emb.cpu().numpy(), vs.labels.cpu().numpy(), vs.size),
                 train.m)
    del pred
    # Q8's one-rank step, alone on the card before the rank group
    work = Path(tempfile.mkdtemp(prefix="phase-q-"))
    t0 = time.perf_counter()
    q8_one_out = run_ranks(f"{ROOT / 'chip_smoke.py'}:q8_one", 1,
                           backend="gloo", device=dev.type,
                           timeout=Q_TIMEOUT,
                           args=dict(path=str(work / "q8_moments")))[0]
    q8_one_s = time.perf_counter() - t0
    say(f"Q8 one-rank process: {q8_one_s:.1f} s")
    # the 16k predictions go to the ranks through run_ranks's argument file
    args = dict(q1=dict(cost=cost.cpu(), cap=cap.cpu(), budget=budget),
                q2=q2_arrays, q7_dir=str(work / "q7"),
                q8_path=str(work / "q8_moments"))
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(f"{ROOT / 'chip_smoke.py'}:q_rank", Q_RANKS,
                          backend="gloo", device=dev.type,
                          timeout=Q_TIMEOUT, args=args)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    group_s = time.perf_counter() - t0
    say(f"Q: {Q_RANKS} ranks on one {dev.type} device, backend gloo "
        f"(collectives staged through host memory): the group took "
        f"{group_s:.1f} s (rank 0: Q1+Q2 {ranks[0]['q12_s']:.1f} s, Q3 "
        f"{ranks[0]['q3_s']:.1f} s, Q4 {ranks[0]['q4_s']:.1f} s, Q5 "
        f"{ranks[0]['q5_s']:.1f} s, Q6 {ranks[0]['q6_s']:.1f} s, Q7 "
        f"{ranks[0]['q7']['s']:.1f} s, Q8 {ranks[0]['q8']['s']:.1f} s)")
    summary = dict(ranks=Q_RANKS, backend="gloo", group_s=group_s)

    # Q1: the one-rank blocked solve (on the card: the one-launch cluster
    # ascent) on the same calls, and the ranks held to it bit for bit
    one = q1_run(torch, dev, args["q1"])
    n, m = cost.shape
    stats_launches = 0
    q1 = {}
    for key, want in one.items():
        if key[1] == "ms":
            continue
        for r, rk in enumerate(ranks):
            got = rk["q1"][key]
            same = (torch.equal(got["x"], want["x"])
                    and _same_list(got["info"], want["info"])
                    and _same_list(got.get("state", []),
                                   want.get("state", [])))
            check(same, f"Q1 {key} rank {r}: the sharded solve differs from"
                  " the one-rank blocked solve")
            iters_run = int(got["info"][7])
            loop = loop_iterations(200 if key[1] == "stall" else Q1_ITERS,
                                   iters_run)
            check(got["stats"] == loop and got["blocked"] == 0,
                  f"Q1 {key} rank {r}: {got['stats']} shard-statistics "
                  f"launches, {got['blocked']} blocked, for a loop of {loop}")
            rows = got["x"].shape[0]
            want_bytes = sharded_solve_bytes(loop, Q1_SHARDS, m, rows,
                                             norm_grad=True)
            check(got["moved"]["all-gather"] == want_bytes,
                  f"Q1 {key} rank {r}: gathered {got['moved']} bytes, "
                  f"stated {want_bytes}")
            stats_launches += got["stats"]
        check(want["blocked"] == 1 and want["stats"] == 0,
              f"Q1 {key}: the one-rank solve was not one blocked launch")
        row = q1[" ".join(key)] = dict(
            iters_run=int(want["info"][7]),
            launches_a_rank=ranks[0]["q1"][key]["stats"],
            gathered_bytes=ranks[0]["q1"][key]["moved"]["all-gather"])
        fields = "SolveInfo, DualState" if "state" in want else "SolveInfo"
        say(f"Q1 {key[0]} {key[1]}: {Q_RANKS} ranks = the one-rank blocked "
            f"solve bit for bit (x, {fields}); iters_run {row['iters_run']},"
            f" {row['launches_a_rank']} shard-statistics launches a rank "
            f"(the loop's iterations: whole chunks of 8 up to the stall "
            f"exit), {row['gathered_bytes']:,} bytes all-gathered a rank")
    for mode in ("quality", "budget"):
        sharded_ms = statistics.median(rk["q1"][(mode, "ms")]
                                       for rk in ranks)
        q1[f"{mode} ms"] = dict(sharded=sharded_ms,
                                one_rank=one[(mode, "ms")])
        say(f"Q1 {mode}: a cold solve at N {n:,} takes {sharded_ms:.2f} ms "
            f"on {Q_RANKS} ranks time-sliced on one card over gloo (not a "
            f"multi-card time), {one[(mode, 'ms')]:.3f} ms as one cluster "
            f"launch on one rank")
    summary["Q1"] = q1
    if dev.type == "cuda":
        stats_err = max(rk["stats_err"] for rk in ranks)
        check(all(rk["stats_same"] for rk in ranks),
              "Q: a rank's shard-statistics kernel differs from its plain "
              "version")
    else:
        stats_err = 0.0

    # Q2: the one-rank stream on the card
    one2 = q2_run(torch, np, dev, q2_arrays)
    vote_launches = 0
    for r, rk in enumerate(ranks):
        got = rk["q2"]
        check(got["mult"] == Q2_SHARDS and one2["mult"] == Q2_SHARDS,
              f"Q2 rank {r}: window_multiple() {got['mult']}")
        for w, (a, b) in enumerate(zip(got["xs"], one2["xs"])):
            check(len(a) == Q2_WINDOWS[w] and np.array_equal(a, b),
                  f"Q2 rank {r} window {w}: assignments differ")
        # the ledger exact, as the reference's 8-device test asks: on the
        # card a rank's predictions of its rows are the whole window's bit
        # for bit (not so on the CPU, whose float32 sigmoid rounds a
        # batch's vector body and scalar tail apart: ROADMAP C14)
        st, st0 = got["state"], one2["state"]
        for i, f in ((2, "budget_spent"), (3, "sr_deficit"), (4, "steps")):
            check(bool(torch.equal(st[i], st0[i])), f"Q2 rank {r}: {f} "
                  "differs from the one-rank stream's")
        for i, f in ((0, "lam"), (1, "lam_load")):
            check(bool(torch.allclose(st[i], st0[i], rtol=1e-4, atol=1e-5)),
                  f"Q2 rank {r}: {f} beyond rtol 1e-4, atol 1e-5")
        vote, stats, blocked = got["launches"]
        check(vote > 0 and stats > 0 and blocked == 0,
              f"Q2 rank {r}: launches (vote, shard statistics, blocked) "
              f"{got['launches']}")
        vote_launches += vote
        stats_launches += stats
    summary["Q2"] = dict(windows=list(Q2_WINDOWS),
                         launches_rank0=ranks[0]["q2"]["launches"],
                         one_rank_launches=one2["launches"])
    say(f"Q2: OmniRouter + StreamController over windows {Q2_WINDOWS}, "
        f"window_multiple() {Q2_SHARDS}: assignments = the one-rank stream "
        f"bit for bit on every rank, and the ledger's steps, budget spent "
        f"and deficit; λ within rtol 1e-4;"
        f" rank 0's launches (vote, shard statistics, blocked) "
        f"{ranks[0]['q2']['launches']}, one rank's {one2['launches']}")

    # Q3: moe_ep against moe_dense (capacity factor 8) and the one-rank
    # local body's drops (capacity factor 1), with every expert on the card
    cfg = q3_config(Q3_CFS[0])
    params = q3_params(torch, dev, cfg, range(cfg.n_experts),
                       slice(None))
    x = q3_tokens(torch, dev, cfg)
    with torch.no_grad():
        dense = moe.moe_dense(cfg, params, x[None])[0]
    scale = float(dense.float().abs().max())
    q3 = {}
    for shape in Q3_SHAPES:
        t_loc = Q3_TOKENS // shape[0]
        peak = max(rk["q3"][(shape, "peak")] for rk in ranks) / 2 ** 30
        for cf in Q3_CFS:
            err, drops, same_drops = 0.0, 0, True
            for r, rk in enumerate(ranks):
                got = rk["q3"][(shape, cf)]
                dc = r // shape[1]
                xl = x[dc * t_loc:(dc + 1) * t_loc]
                if cf == Q3_CFS[0]:
                    want = dense[dc * t_loc:(dc + 1) * t_loc]
                else:
                    st = {}
                    with torch.no_grad():
                        want = moe._moe_local(
                            q3_config(cf), xl, params["router"],
                            params["w_gate"], params["w_up"],
                            params["w_down"], n_dest=1, stats=st)
                    same_drops = same_drops and bool(
                        torch.equal(st["keep"].cpu(), got["keep"]))
                drops += int((~got["keep"]).sum())
                err = max(err, float((got["y"].float()
                                      - want.float().cpu()).abs().max()))
            moved = ranks[0]["q3"][(shape, cf)]["moved"]
            ms = statistics.median(rk["q3"][(shape, cf)]["ms"]
                                   for rk in ranks)
            tag = f"Q3 {shape[0]}x{shape[1]} cf {cf:g}"
            yard = ("moe_dense" if cf == Q3_CFS[0]
                    else "_moe_local(n_dest=1)")
            say(f"{tag}: max|moe_ep - {yard}| {err:.4g} ({err / scale:.3g} "
                f"of the largest output "
                f"{scale:.4g}; limit {Q3_TOL:.4g}); dropped copies {drops},"
                f" same drops {same_drops}; rank 0 moved "
                f"{moved['all-to-all']:,} bytes all-to-all, "
                f"{moved['all-reduce']:,} all-reduce; {ms:.1f} ms a layer "
                f"(4 ranks time-sliced, gloo through the host); peak "
                f"{peak:.2f} GiB a rank")
            check(err <= Q3_TOL * scale, f"{tag}: beyond the bf16 limit")
            check(same_drops, f"{tag}: the dropped copies differ")
            if cf == Q3_CFS[0]:
                check(drops == 0, f"{tag}: copies dropped at capacity 8")
            else:
                check(drops > 0, f"{tag}: nothing dropped at capacity 1")
            q3[f"{shape[0]}x{shape[1]} cf{cf:g}"] = dict(
                err=err, rel=err / scale, drops=drops, ms=ms,
                peak_gib=peak, all_to_all=moved["all-to-all"],
                all_reduce=moved["all-reduce"])
    del params, dense
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    summary["Q3"] = q3

    # Q4
    q4 = ranks[0]["q4"]
    for r, rk in enumerate(ranks):
        for method in ("int8", "bf16"):
            got = rk["q4"][method]
            check(got["excess"] <= 0.0 and got["same_err"],
                  f"Q4 {method} rank {r}: the mean or the residual differs "
                  "from the plain mean of the dequantised blocks")
        check(rk["q4"]["pipeline"] <= Q4_PIPE_TOL,
              f"Q4 pipeline rank {r}: {rk['q4']['pipeline']:.3g} from the "
              "sequential product")
    say(f"Q4: compressed all-reduce of {Q4_NUMEL:,} float32 over "
        f"{Q_RANKS} ranks, {Q4_STEPS} steps with error feedback: int8 and "
        f"bf16 = the plain mean of the dequantised blocks within the "
        f"stated limits, residuals bit for bit (rank 0 all-reduced "
        f"{q4['int8']['moved']['all-reduce']:,} bytes a step in int8's "
        f"float32, {q4['bf16']['moved']['all-reduce']:,} in bf16); "
        f"pipeline {Q4_STAGES} stages x {Q4_MICRO} microbatches: max|"
        f"pipeline - sequential| {max(rk['q4']['pipeline'] for rk in ranks):.3g}")
    summary["Q4"] = dict(pipeline=max(rk["q4"]["pipeline"] for rk in ranks),
                         int8_bytes=q4["int8"]["moved"]["all-reduce"],
                         bf16_bytes=q4["bf16"]["moved"]["all-reduce"])
    summary["Q5"] = q5_report(torch, dev, say, check, ranks)
    summary["Q6"] = q6_report(torch, dev, say, check, ranks)
    summary["Q7"] = q7_report(torch, dev, say, check, ranks)
    summary["Q8"] = q8_report(torch, dev, say, check, ranks, q8_one_out)
    summary["Q8"]["one_rank_process_s"] = q8_one_s
    # the sharded steps' flash launches (Q5, Q7 float32; Q8 bf16)
    summary["sharded_flash"] = [sum(summary[q]["flash_launches"][i]
                                    for q in ("Q5", "Q7", "Q8"))
                                for i in (0, 1)]
    check(stats_launches > 0, "Q: no shard-statistics launch on the ranks")
    summary["shard_stats_launches"] = stats_launches
    summary["vote_launches"] = vote_launches
    summary["seconds"] = time.perf_counter() - t_all
    say(f"phase Q: {summary['seconds']:.1f} s")
    return stats_launches, vote_launches, stats_err, summary


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _f32(tree):
    """A float32 configuration's init (bf16 leaves, as the reference
    declares them) cast to float32, as the reference's float32 checks cast
    theirs (``common.cast_tree``)."""
    from repro_torch.common import cast_tree
    return cast_tree(tree)


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
    from repro_torch.kernels.lagrangian_assign.kernel import dual_solve_cuda
    from repro_torch.kernels.topk_retrieval import ops as tr_ops

    def say(*parts):
        print(*parts, flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False   # plain vote in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    t_mark = [t_all]

    def mark(tag):
        """Print the seconds since the previous mark."""
        now = time.perf_counter()
        say(f"time: {tag} {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    # 1. device
    card = gpu_line()
    say("device:", card, "| torch", torch.__version__, "cuda",
        torch.version.cuda, "| python", sys.version.split()[0])

    # 2. build every kernel library, one nvcc each, in parallel
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
    mark("device and build")
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

    # 3a. retrieval vote vs its plain version; its SASS holds tensor-core
    # instructions in both instances
    mma = sass_hmma("retrieval_vote")
    say(f"retrieval SASS: tensor-core instructions per kernel {mma}")
    check(sum(1 for f, n in mma.items() if "retrieval_kernel" in f and n > 0)
          == 2, "retrieval: a retrieval_kernel instance has no HMMA")
    rows["retrieval_vote"] = vote_phase(torch, say, check, time_ms, emb,
                                        labels, q_route, k, n_valid)

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
    budget = float(cost.min(1).values.sum()) * 1.6
    rows["dual_solve"], solve_cases = dual_solve_phase(
        torch, say, check, time_ms, dev, cost, cap, budget)
    mark("data, 3a and 3b")

    # 3c. top-k retrieval; 3d. the assign step; 3e. the seed's
    # per-iteration solve and the legacy / sweep entry points
    rows["topk_retrieval"] = topk_phase(torch, say, check, time_ms, emb,
                                        labels, q_route, k, n_valid)
    p_q, iters_q, _ = solve_cases[("quality", "cold")]
    _, i_q = la_ops.finish(dual_solve_cuda(*p_q.args, iters=iters_q,
                                           patience=3), p_q)
    rows["assign_step"] = assign_step_phase(torch, say, check, time_ms, dev,
                                            cost, cap, i_q.lam, i_q.lam_load)
    rows["assign_step"]["launches"], seed_tm = seed_loop_phase(
        torch, say, check, time_ms, dev)
    rows["assign_step"].update(seed_tm)
    mark("3c, 3d and 3e")

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

    # V2. the shard-statistics kernel and the masked stream, card vs CPU
    mark("4 and 5")
    rows["shard_stats"] = masked_solve_phase(torch, np, dev, say, check,
                                             time_ms, hp)
    mark("V2")
    # G4. the runtime guards on the card: no_host_sync live, the solver
    # clean under it, no compile event in a warmed pass
    g4, g4_sites = guards_phase(torch, np, dev, say, check, cost, cap)
    mark("G4")
    # Q. distribution: four ranks on the card over gloo (the sharded solve
    # of these predictions, the query-sharded stream, moe_ep at dbrx's
    # widths, the compressed all-reduce and the pipeline)
    q_stats, q_vote, q_err, q_summary = sharded_phase(
        torch, np, dev, say, check, cost, cap, budget)
    rows["shard_stats"]["per_iteration_kernel"]["launches"] = q_stats
    rows["shard_stats"]["per_iteration_kernel"]["max_abs_err"] = max(
        rows["shard_stats"]["per_iteration_kernel"]["max_abs_err"], q_err)
    rows["retrieval_vote"]["launches"] += q_vote
    rows["retrieval_vote"]["sharded_launches"] = q_vote
    mark("Q")

    # T. ECCOS-T, ECCOS-H and S3 fit on the card
    fits = predictor_fit_phase(torch, np, dev, say, check)
    mark("T (card)")

    # S. the event-driven serving simulator (run_serving) on the card, with
    # Table 2's six policies in S1; the CPU side of T runs in its workers
    sim = serving_sim_phase(torch, np, dev, say, check, hp.retrieval,
                            route_ds, fits)
    fit_summary = predictor_fit_report(np, say, check, fits, sim["cpu_fits"])
    mark("S")

    del hp, hp_cpu, hp_gpu, emb, labels, proj, q_route
    # F1 and D1. the flash and dense decode kernels against their plain
    # versions at the main path's shapes
    rows["flash_attention"] = flash_kernel_phase(torch, np, say, check, dev,
                                                 time_ms)
    rows["decode_attention"] = dense_decode_phase(torch, say, check, dev,
                                                  time_ms)
    mark("F1 and D1")
    heads = fits["ECCOS-H"][0].trained.params
    del fits
    rows["paged_decode_attention"], main = serving_plane(
        torch, np, dev, say, check, time_ms, heads)
    mark("serving plane, R1, R2 and E2")
    # E1. the failure plane on the float32 smoke pool, card vs CPU
    e1_paged, e1_flash = failure_plane_smoke(torch, np, dev, say, check)
    mark("E1")
    # G3. the schedule race checker on the card (after E1 warmed its
    # kernels)
    g3 = race_phase(torch, np, dev, say, check)
    mark("G3")
    # H. the recurrent families: hymba-1.5b (H1) and its endpoint (H3),
    # xlstm-350m (H2) at full width, the reference's six-model pool (H4)
    h_runs, h_summary = recurrent_phase(torch, np, dev, say, check)
    mark("H")
    # M and X. the MoE family (dbrx-132b, llama4-maverick-400b-a17b) and the
    # encoder-decoder (seamless-m4t-large-v2) at full width
    mx_runs, mx_summary = moe_encdec_phase(torch, np, dev, say, check)
    mark("M and X")
    # L. language-model training: the flash backward kernel (L1),
    # h2o-danube-3-4b at full width (L2), the launcher and resume (L3),
    # card against CPU per family (L4)
    rows["flash_attention_bwd"], l_runs, l_summary = training_phase(
        torch, np, dev, say, check, time_ms)
    mark("L")
    # N. the serving launcher with five pool members at full width (N1) and
    # the analysis plane on the card (N2: L2's profiled step, a decode chunk)
    n_runs, n_summary = serve_analysis_phase(torch, np, dev, say, check,
                                             l_summary["L2"])
    del l_summary["L2"]["profile"]
    mark("N")
    rows["paged_decode_attention"]["launches"] += (e1_paged + g3["paged"]
                                                   + h_runs["paged"]
                                                   + mx_runs["paged"]
                                                   + n_runs["paged"])
    sharded_flash = q_summary["sharded_flash"]
    rows["flash_attention"]["launches"] = (main["flash"] + e1_flash
                                           + g3["flash"] + h_runs["flash"]
                                           + mx_runs["flash"]
                                           + l_runs["flash"]
                                           + n_runs["flash"]
                                           + sharded_flash[0])
    rows["flash_attention"]["sharded_step_launches"] = sharded_flash[0]
    rows["flash_attention_bwd"]["launches"] += sharded_flash[1]
    rows["flash_attention_bwd"]["sharded_step_launches"] = sharded_flash[1]
    q6 = q_summary["Q6"]
    rows["decode_attention"]["launches"] = (main["dense"] + h_runs["dense"]
                                            + mx_runs["dense"]
                                            + q6["partial_launches"])
    rows["decode_attention"]["partials_launches"] = q6["partial_launches"]
    rows["decode_attention"]["partials_max_rel_err"] = q6["partials_rel_err"]
    rows["decode_attention"]["max_abs_err"] = max(
        rows["decode_attention"]["max_abs_err"], main["i1"]["kernel_err"])
    rows["retrieval_vote"]["launches"] += (main["vote"] + g3["vote"]
                                           + h_runs["vote"] + n_runs["vote"])
    rows["dual_solve"]["launches"] += (main["dual_solve"] + g3["dual_solve"]
                                       + g4["dual_solve"]
                                       + h_runs["dual_solve"]
                                       + n_runs["dual_solve"])

    # V1. the paged verify kernel against its plain version and decode
    verify_err = verify_kernel_phase(torch, say, check, dev)
    mark("V1")
    # V3, V4 and the smoke spec pool card vs CPU
    (rows["paged_verify_attention"], blocked_launches,
     blocked_err, g2_spec) = speculative_plane(torch, np, dev, say, check,
                                               time_ms)
    mark("V3, V4, G2 (spec stream) and the smoke spec pool")
    rows["paged_verify_attention"]["max_abs_err"] = verify_err
    rows["shard_stats"]["launches"] = (blocked_launches + g4["blocked"]
                                       + n_runs["blocked"])
    rows["shard_stats"]["max_abs_err"] = max(
        rows["shard_stats"]["max_abs_err"], blocked_err)

    # phase S's launches join those of the main path's other runs
    for key, row in (("vote", "retrieval_vote"), ("dual_solve", "dual_solve"),
                     ("blocked", "shard_stats")):
        rows[row]["launches"] += sim["launches"][key]
        rows[row]["serving_sim_launches"] = sim["launches"][key]
    rows["retrieval_vote"]["max_abs_err"] = max(
        rows["retrieval_vote"]["max_abs_err"], sim["errs"]["vote"])
    rows["shard_stats"]["max_abs_err"] = max(
        rows["shard_stats"]["max_abs_err"], sim["errs"]["blocked"])
    say("phase S runs: " + json.dumps(sim["runs"]))
    say("phase I: " + json.dumps(main["i1"], default=str))
    say("phase G: " + json.dumps(dict(g2_spec=g2_spec, g3=g3, g4=g4,
                                      g4_runs=g4_sites), default=str))
    say("phase T: " + json.dumps(fit_summary))
    say("phase H: " + json.dumps(h_summary))
    say("phases M and X: " + json.dumps(mx_summary))
    say("phase L: " + json.dumps(l_summary))
    say("phase N: " + json.dumps(n_summary))
    say("phase Q: " + json.dumps(q_summary, default=str))

    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"total {time.perf_counter() - t_all:.1f} s; peak device memory "
        f"since the endpoint phase {peak:.2f} GiB")
    kernels = [rows[k] for k in ("retrieval_vote", "dual_solve",
                                 "paged_decode_attention", "shard_stats",
                                 "paged_verify_attention", "flash_attention",
                                 "decode_attention", "topk_retrieval",
                                 "assign_step", "flash_attention_bwd")]
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
