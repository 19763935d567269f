"""Multi-LLM serving engine: the router in front of a pool of zoo models
with paged-KV continuous batching and per-endpoint concurrency limits.

The port of ``repro.serving.engine`` on its non-speculative path.  Each
:class:`Endpoint` owns one architecture and serves up to ``L`` concurrent
sequences out of a **fixed-shape paged state**: KV lives in page pools
``(n_pages, page_size, K, D)`` shared by all slots, each slot owns a row of
a block table, and per-sequence lengths replace a packed batch's single
position.  Admitting a request prefills *only that request* (prompt padded
to a page multiple) and scatters its KV into free pages; a completion frees
pages without touching any other sequence (``batch_reprefills`` stays 0).

The decode inner loop is fused: ``sync_every`` single-token steps run as one
chunk with on-device argmax and a done-mask, so the host syncs once per
chunk, and :meth:`MultiLLMServer.run` dispatches every endpoint's chunk
before it blocks on any result.

The :class:`MultiLLMServer` runs on the control loop of
``repro_torch.core.control``: requests are released by arrival step,
admitted per the paper's capacity rule and routed through a Policy.

Not ported yet (each raises ``NotImplementedError`` when turned on):
hedging, the fault plan, the health plane, the stall watchdog, speculative
pair columns, online fold-back, a stream ``horizon`` and the sanitizer
hooks; ``RestartEndpoint`` waits too.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common import default_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.control import (AdmissionRule, ControlLoop,
                                      StreamController)
from repro_torch.models import build_model
from repro_torch.models.zoo import (PAGED_POOL_KEYS, pages_per_request,
                                    prefill_into_pages, reset_slot)


def null_route_features(batch):
    """Feature producer for driving :class:`MultiLLMServer` without a
    dataset: a load-balancing-only RouteBatch (uniform prices/lengths, no
    ground truth)."""
    from repro_torch.core.baselines import RouteBatch

    class _Features:
        queries = ["q"] * len(batch)

        def route_batch(self, loads, counts, with_truth=False):
            n, m = len(batch), len(loads)
            return RouteBatch(queries=["q"] * n, input_len=np.ones(n),
                              price_in=np.ones(m), price_out=np.ones(m),
                              loads=loads, counts=counts)

    return _Features()


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray           # prompt token ids
    max_new: int = 16
    submitted: float = 0.0
    endpoint: int = -1
    output: Optional[List[int]] = None
    done: bool = False
    started: float = 0.0
    finished: float = 0.0
    admit_step: float = 0.0      # engine clock (decode chunk) at admission


class PageAllocator:
    """Host-side free lists for the paged state: physical KV pages and
    sequence slots.  Page 0 is the *dump page* — never handed out; free and
    finished slots keep their block-table rows zeroed so their (masked)
    in-flight writes land there instead of in anyone's live pages."""

    def __init__(self, n_pages: int, n_slots: int):
        self.n_pages = n_pages
        self.n_slots = n_slots
        self.free_pages: List[int] = list(range(n_pages - 1, 0, -1))
        self.free_slots: List[int] = list(range(n_slots - 1, -1, -1))
        self._free_page_set = set(self.free_pages)

    def alloc_pages(self, n: int) -> List[int]:
        if n > len(self.free_pages):
            raise RuntimeError(f"page pool exhausted: want {n}, "
                               f"free {len(self.free_pages)}")
        # take the tail in one slice + delete (same order as repeated pop())
        # so a failure above leaves the free list untouched
        pages = self.free_pages[:-n - 1:-1]
        del self.free_pages[len(self.free_pages) - n:]
        self._free_page_set.difference_update(pages)
        return pages

    def release_pages(self, pages: List[int]):
        for p in pages:
            if not 0 < p < self.n_pages or p in self._free_page_set:
                raise RuntimeError(f"release of page {p}: the dump page, out "
                                   "of range, or already free")
            self.free_pages.append(p)
            self._free_page_set.add(p)

    def alloc_slot(self) -> int:
        if not self.free_slots:
            raise RuntimeError(f"slot pool exhausted: all {self.n_slots} "
                               f"slots in use")
        return self.free_slots.pop()

    def release_slot(self, slot: int):
        if slot in self.free_slots:
            raise RuntimeError(f"slot {slot} released twice")
        self.free_slots.append(slot)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host mirror on ``device`` without a host sync.  A copy from
    pageable memory would wait for the work already queued on the stream
    (the chunks other endpoints just dispatched); a pinned, non-blocking
    copy queues behind it instead.  The pinned staging buffer is a copy, so
    the mirror may change right after."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


class Endpoint:
    """One pool member: a zoo model served from a fixed-shape paged state.

    ``params`` (a tree in the reference's layout) replaces the random init
    from ``seed``; the state lives on ``device`` (CUDA unless named)."""

    def __init__(self, cfg: ModelConfig, *, max_concurrency: int = 4,
                 t_max: int = 128, seed: int = 0, page_size: int = 16,
                 sync_every: int = 8, params=None, device=None):
        self.cfg = cfg
        self.device = default_device(device)
        self.L = max_concurrency
        self.page_size = page_size
        self.pages_per_slot = -(-t_max // page_size)
        self.t_max = self.pages_per_slot * page_size
        self.sync_every = sync_every
        self.model = build_model(cfg)
        self.params = (self.model.init(seed, self.device) if params is None
                       else params)

        probe = self.model.empty_paged_state(1, 1, page_size, device="meta")
        leaves_keys = {k for seg in probe["segs"] for layer in seg
                       for k in layer}
        self._has_kv = "k" in leaves_keys
        self._has_recurrent = bool(leaves_keys - set(PAGED_POOL_KEYS))
        # worst case: every slot at t_max, +1 for the dump page
        n_pages = 1 + self.L * self.pages_per_slot if self._has_kv else 1
        self.alloc = PageAllocator(n_pages, self.L)
        self._state = self.model.empty_paged_state(self.L, n_pages, page_size,
                                                   device=self.device)

        # host mirrors of the per-slot device vectors
        self.block_table = np.zeros((self.L, self.pages_per_slot), np.int32)
        self.lens = np.zeros((self.L,), np.int32)
        self.remaining = np.zeros((self.L,), np.int32)
        self.last_tokens = np.zeros((self.L, 1), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * self.L
        self._slot_pages: List[List[int]] = [[] for _ in range(self.L)]

        self.busy_steps = 0          # chunks dispatched
        self.decoded_tokens = 0      # real (non-masked) tokens emitted
        self.prefill_calls = 0       # one per admitted request
        self.batch_reprefills = 0    # ALWAYS 0 here — the restart metric

    def active_count(self) -> int:
        return self.L - len(self.alloc.free_slots)

    def has_capacity(self) -> bool:
        return bool(self.alloc.free_slots)

    def active_requests(self) -> List[Request]:
        return [r for r in self.slot_req if r is not None]

    def _free_slot(self, slot: int):
        self.slot_req[slot] = None
        self.block_table[slot] = 0
        if self._has_kv:
            self.alloc.release_pages(self._slot_pages[slot])
            self._slot_pages[slot] = []
        self.alloc.release_slot(slot)

    def cancel(self, req: Request) -> bool:
        """Release a still-decoding request's slot and pages.  Runs only
        between chunks: the freed block-table row is zeroed so the slot's
        masked in-flight writes land on the dump page."""
        for slot, r in enumerate(self.slot_req):
            if r is req:
                self._free_slot(slot)
                self.lens[slot] = 0
                self.remaining[slot] = 0
                self.last_tokens[slot, 0] = 0
                return True
        return False

    def can_serve(self, req: Request) -> bool:
        """Whether the request fits this endpoint's fixed shapes at all:
        prompt + output budget within t_max."""
        return len(req.tokens) - 1 + req.max_new <= self.t_max

    # -- admission -----------------------------------------------------------
    def _bucket(self, plen: int) -> int:
        """Prompt-length bucket: attention KV tolerates right-pad garbage
        (masked by ``lens``), so pure-attention models prefill at page
        multiples; recurrent state would need the exact length."""
        if self._has_recurrent:
            return plen
        return -(-plen // self.page_size) * self.page_size

    def admit(self, req: Request) -> int:
        """Prefill this request only and wire its pages/slot into the fixed
        batch — no other sequence is touched."""
        if not self.has_capacity():
            raise RuntimeError("admit on a full endpoint")
        toks = np.asarray(req.tokens, np.int32)
        plen = len(toks) - 1            # last prompt token is fed to decode
        if plen + req.max_new > self.t_max:
            raise ValueError(f"request {req.rid} needs {plen + req.max_new} "
                             f"positions, endpoint t_max={self.t_max}")
        req.started = time.perf_counter()
        req.output = []
        slot = self.alloc.alloc_slot()
        if self._has_kv:
            pages = self.alloc.alloc_pages(
                pages_per_request(plen, req.max_new, self.page_size))
            self._slot_pages[slot] = pages
            self.block_table[slot] = 0
            self.block_table[slot, :len(pages)] = pages
        if plen > 0:
            bucket = self._bucket(plen)
            ptoks = np.zeros((1, bucket), np.int32)
            ptoks[0, :plen] = toks[:-1]
            cache, _ = self.model.prefill(
                self.params, torch.as_tensor(ptoks, device=self.device))
            n_prefill_pages = -(-bucket // self.page_size) if self._has_kv else 0
            page_ids = torch.as_tensor(
                self._slot_pages[slot][:n_prefill_pages], dtype=torch.long,
                device=self.device)
            prefill_into_pages(self._state, cache, page_ids, slot,
                               self.page_size)
            self.prefill_calls += 1
        elif self._has_recurrent:
            reset_slot(self._state, slot)
        self.lens[slot] = plen
        self.remaining[slot] = req.max_new
        self.last_tokens[slot, 0] = toks[-1]
        self.slot_req[slot] = req
        return slot

    # -- fused decode chunk --------------------------------------------------
    def _chunk(self, block_table, last, lens, remaining):
        """``sync_every`` decode steps with on-device argmax sampling; the
        done-mask freezes finished sequences (their writes land at their own
        frozen position, or the dump page once the slot is freed).  Every
        tensor stays on the device: nothing here waits for the card."""
        vocab = self.cfg.vocab_size
        toks = []
        for _ in range(self.sync_every):
            _, logits = self.model.decode_step_paged(
                self.params, self._state, last, block_table, lens)
            nxt = torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)
            active = remaining > 0
            nxt = torch.where(active, nxt, 0)
            lens = lens + active.to(torch.int32)
            remaining = torch.clamp(remaining - 1, min=0)
            last = nxt[:, None]
            toks.append(nxt)
        return last, lens, remaining, torch.stack(toks, dim=1)

    def step_begin(self):
        """Dispatch one decode chunk (async) — does not block."""
        if self.active_count() == 0:
            return None
        dev = self.device
        out = self._chunk(_to_device(self.block_table, dev),
                          _to_device(self.last_tokens, dev),
                          _to_device(self.lens, dev),
                          _to_device(self.remaining, dev))
        self.busy_steps += 1
        return out

    def step_end(self, pending) -> List[Request]:
        """Block on the chunk result, distribute tokens, free completions."""
        if pending is None:
            return []
        last, lens, remaining, toks = (np.array(x.cpu()) for x in pending)
        finished = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            take = int(min(self.remaining[slot], self.sync_every))
            req.output.extend(int(t) for t in toks[slot, :take])
            self.decoded_tokens += take
            if remaining[slot] == 0:
                req.done = True
                req.finished = time.perf_counter()
                finished.append(req)
                self._free_slot(slot)
                lens[slot] = 0
                last[slot] = 0
        self.last_tokens = last
        self.lens = lens
        self.remaining = remaining
        return finished

    def step(self) -> List[Request]:
        """One decode chunk for every active sequence (dispatch + collect)."""
        return self.step_end(self.step_begin())


class _EngineExecutor:
    """The endpoint pool behind the control loop: the stream clock is the
    decode chunk index, ``advance`` dispatches every endpoint's chunk before
    blocking on any result, and the live per-endpoint in-flight counts are
    what the routing window sees."""

    def __init__(self, server: "MultiLLMServer", max_steps: int):
        self.server = server
        self.max_steps = max_steps
        self.steps = 0
        self.stopped = False

    def now(self) -> float:
        return float(self.steps)

    def loads(self) -> np.ndarray:
        return np.array([float(e.L) for e in self.server.endpoints], float)

    def counts(self) -> np.ndarray:
        return np.array([float(e.active_count())
                         for e in self.server.endpoints], float)

    def dispatch(self, items, x) -> List[Request]:
        rejected = []
        x = np.asarray(x)
        srv = self.server
        for req, j in zip(items, x):
            j = int(j)
            ep = srv.endpoints[j]
            if not ep.can_serve(req):
                # can NEVER fit this endpoint's fixed shapes: fail it cleanly
                # instead of crashing the server or re-queueing forever
                req.done = True
                req.endpoint = j
                req.output = []
                req.finished = time.perf_counter()
                srv.completed.append(req)
                continue
            if ep.has_capacity():
                req.endpoint = j
                req.admit_step = float(self.steps)
                ep.admit(req)
            else:  # paper's queueing: wait for capacity
                rejected.append(req)
        return rejected

    def advance(self, wake_at):
        if self.steps >= self.max_steps:
            self.stopped = True
            return [], False
        eps = self.server.endpoints
        if (sum(e.active_count() for e in eps) == 0 and wake_at is not None
                and wake_at > self.steps):
            # pool idle, traffic still coming: jump to the next arrival
            self.steps = int(np.ceil(wake_at))
            return [], True
        # dispatch every endpoint's chunk before blocking on any result
        pending = [(e, e.step_begin()) for e in eps]
        done: List[Request] = []
        progressed = False
        for e, p in pending:
            fin = e.step_end(p)
            progressed = progressed or bool(fin) or bool(e.active_count())
            done.extend(fin)
        self.steps += 1
        self.server.completed.extend(done)
        return done, progressed


class MultiLLMServer:
    """Router + endpoint pool behind the streaming control loop: admission
    per the paper's capacity rule, arrival-step release, routing windows
    rate-limited to one per ``window_steps`` decode steps (unless a full
    batch is waiting) and resized by ``adapt_window`` (a
    ``core.control.AdaptiveWindow``), and with ``stream=True`` a persistent
    dual state through ``policy.route_window`` (stateless policies only,
    until masked windows are ported: ``horizon``, the stream length a
    stateful policy spreads its budget over, raises until then)."""

    def __init__(self, endpoints: List[Endpoint], policy, *,
                 batch_size: int = 0, hedge_after_steps: int = 0,
                 fold_online: bool = False, stream: bool = False,
                 horizon: int = 0, window_steps: float = 0.0,
                 fault_plan=None, health=None, stall_after_chunks: int = 0,
                 spec_pairs=(), adapt_window=None):
        deferred = {"hedge_after_steps": hedge_after_steps > 0,
                    "fold_online": fold_online,
                    "horizon": horizon > 0,
                    "fault_plan": fault_plan is not None,
                    "health": bool(health),
                    "stall_after_chunks": stall_after_chunks > 0,
                    "spec_pairs": bool(tuple(spec_pairs))}
        on = [name for name, used in deferred.items() if used]
        if on:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(on) + " (ROADMAP Queue A)")
        self.endpoints = endpoints
        self.policy = policy
        cap = sum(e.L for e in endpoints)
        self.rule = AdmissionRule(batch_size).resolve(cap)
        self.batch_size = self.rule.batch_size
        self.max_inflight = self.rule.max_inflight
        self.stream = stream
        self.window_steps = window_steps
        self.adapt_window = adapt_window     # core.control.AdaptiveWindow
        self.queue: deque = deque()     # (arrival_step, Request)
        self.completed: List[Request] = []
        self.route_calls = 0
        self.route_seconds = 0.0
        self.windows = 0
        self.dual_iters = 0
        self._controller: Optional[StreamController] = None

    def submit(self, req: Request, at_step: float = 0.0):
        """Queue a request; ``at_step`` releases it into the stream once
        the engine clock (decode chunk index) reaches it.  A request NO
        endpoint can fit is failed here, before it is ever routed."""
        req.submitted = time.perf_counter()
        if self.endpoints and not any(ep.can_serve(req)
                                      for ep in self.endpoints):
            req.done = True
            req.output = []
            req.finished = time.perf_counter()
            self.completed.append(req)
            return
        self.queue.append((float(at_step), req))

    def run(self, route_features, *, max_steps: int = 10_000):
        # ONE controller for the server's lifetime: a stream's dual state
        # must survive across run() calls
        if self._controller is None:
            self._controller = StreamController(
                self.policy, horizon=len(self.queue), stream=self.stream,
                adapt_window=self.adapt_window)
        controller = self._controller
        windows0 = controller.windows
        iters0 = controller.dual_iters
        items = [req for _, req in self.queue]
        times = np.array([t for t, _ in self.queue])
        self.queue.clear()
        executor = _EngineExecutor(self, max_steps)
        loop = ControlLoop(
            executor=executor, controller=controller, rule=self.rule,
            items=items, features=route_features, arrival_times=times,
            window=self.window_steps)
        loop.run()
        # an early exit (max_steps) leaves un-served requests in the loop's
        # queues — put them back, REBASED to the fresh clock a later run()
        # starts with
        now = executor.now()
        for req in loop.ready:
            self.queue.append((0.0, req))
        for at, _, req in loop.pending:
            self.queue.append((max(0.0, at - now), req))
        self.route_seconds += controller.route_seconds
        controller.route_seconds = 0.0
        self.route_calls += controller.windows - windows0
        self.windows += controller.windows - windows0
        self.dual_iters += controller.dual_iters - iters0
        return self.completed
