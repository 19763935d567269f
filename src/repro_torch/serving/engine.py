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
admitted per the paper's capacity rule and routed through a Policy — with
``stream=True`` through the persistent dual controller, whose padded,
masked windows the router solves in the blocked solve.

The speculative cascade plane: with ``spec_pairs`` (``core.speculative.
SpecPair``; the router's ``RouterConfig.spec_pairs`` prices them as extra
columns), a request routed to a pair column holds a slot on BOTH pair
endpoints.  Every engine step, after the normal chunks, the server runs one
round per pair: the draft endpoint decodes k tokens in one k-step chunk,
the verify endpoint scores all k positions in ONE multi-position paged step
(``DecoderLM.verify_step_paged``, the paged-verify kernel on the card), and
the longest strong-matching prefix plus the strong correction token is
emitted — greedy output equal to the verify endpoint decoding alone.
Rejected draft pages roll back through the allocator; acceptance feeds the
router's ``AcceptanceTracker``.

:class:`RestartEndpoint` keeps the reference's restart-based batching (re-
prefill the whole packed, left-padded batch on every admit and completion,
then decode it one token per step over a dense cache) as the baseline the
paged endpoint is measured against; it serves behind the same server.

The failure plane: ``hedge_after_steps`` duplicates a request still
decoding that many chunks after admission onto the least-loaded other
endpoint (first finisher wins, the straggler is cancelled);
``fault_plan`` (``serving.faults.FaultPlan``) skips the chunks of a hard-
down or slowed endpoint, fails connects to a dead one, sheds past a rate
limit and flips a transient-error coin per request and chunk; ``health``
(``True`` or a ``core.health.HealthTracker``) keeps a breaker per
endpoint, fed in a fixed order each chunk; ``stall_after_chunks`` is the
watchdog that cancels a request whose output has not grown for that many
chunks.  A failed request re-enters the queue after ``backoff_steps`` ·
2^(k−1) chunks on its k-th retry, up to ``retry_budget`` retries, then
completes as ``failed``.  ``fold_online`` folds completions into the
policy's store every ``fold_chunk`` requests.

The sanitizer plane (``repro_torch.analysis.sanitize``): with ``pagesan``
on, every new :class:`Endpoint` attaches a shadow allocator that hears
each alloc and release and audits the endpoint's host page/slot state
after every admit, cancel, chunk, speculative release, page growth and
rollback.  Off, the cost is one ``is None`` check on each of those paths.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.common import default_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.control import (AdmissionRule, ControlLoop,
                                      FoldBuffer, StreamController)
from repro_torch.core.health import HealthTracker
from repro_torch.core.scheduler import fold_completions
from repro_torch.models import build_model
from repro_torch.models.zoo import (PAGED_POOL_KEYS, pad_cache,
                                    pages_per_request, prefill_into_pages,
                                    reset_slot)


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
class _SpecSeq:
    """One speculative sequence: a slot on BOTH pair endpoints, driven by
    the server's pair rounds instead of the chunk loop.  ``base`` is the
    accepted length (prompt + emitted tokens) — both endpoints' ``lens``
    mirrors equal it between rounds; ``pending`` is the next token to feed
    (the strong model's last emission, or the final prompt token)."""
    req: "Request"
    pair: int
    d_slot: int
    v_slot: int
    pending: int
    base: int
    remaining: int


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
    hedged: bool = False
    admit_step: float = 0.0      # engine clock (decode chunk) at admission
    retries: int = 0             # failed attempts so far (failure plane)
    failed: bool = False         # permanently failed (retry budget spent)


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
        # PageSan shadow allocator (repro_torch.analysis.sanitize); None =
        # off, and the only cost on this path is the None check below
        self.san = None

    def alloc_pages(self, n: int) -> List[int]:
        if n > len(self.free_pages):
            raise RuntimeError(f"page pool exhausted: want {n}, "
                               f"free {len(self.free_pages)}")
        # take the tail in one slice + delete (same order as repeated pop())
        # so a failure above leaves the free list untouched
        pages = self.free_pages[:-n - 1:-1]
        del self.free_pages[len(self.free_pages) - n:]
        self._free_page_set.difference_update(pages)
        if self.san is not None:
            self.san.on_alloc_pages(pages)
        return pages

    def release_pages(self, pages: List[int]):
        for p in pages:
            if not 0 < p < self.n_pages or p in self._free_page_set:
                raise RuntimeError(f"release of page {p}: the dump page, out "
                                   "of range, or already free")
            self.free_pages.append(p)
            self._free_page_set.add(p)
        if self.san is not None:
            self.san.on_release_pages(pages)

    def alloc_slot(self) -> int:
        if not self.free_slots:
            raise RuntimeError(f"slot pool exhausted: all {self.n_slots} "
                               f"slots in use")
        slot = self.free_slots.pop()
        if self.san is not None:
            self.san.on_alloc_slot(slot)
        return slot

    def release_slot(self, slot: int):
        if slot in self.free_slots:
            raise RuntimeError(f"slot {slot} released twice")
        self.free_slots.append(slot)
        if self.san is not None:
            self.san.on_release_slot(slot)


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
        if cfg.family == "encdec":
            # the reference's error; the port's RestartEndpoint refuses the
            # family too
            raise NotImplementedError("paged serving covers decoder LMs; "
                                      "serve enc-dec via RestartEndpoint")
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
        self.spec_slots: set = set()   # slots driven by the speculative plane

        self.busy_steps = 0          # chunks dispatched
        self.decoded_tokens = 0      # real (non-masked) tokens emitted
        self.prefill_calls = 0       # one per admitted request
        self.batch_reprefills = 0    # ALWAYS 0 here — the restart metric

        if _sanitize.active("pagesan"):
            _sanitize.PageSan.attach(self)

    def _san_check(self):
        """Full PageSan audit between chunks; one None check when off."""
        san = self.alloc.san
        if san is not None:
            san.check_endpoint(self)

    def active_count(self) -> int:
        return self.L - len(self.alloc.free_slots)

    def has_capacity(self) -> bool:
        return bool(self.alloc.free_slots)

    def active_requests(self) -> List[Request]:
        return [r for r in self.slot_req if r is not None]

    def _free_slot(self, slot: int):
        self.spec_slots.discard(slot)
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
                self._san_check()
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
        self._san_check()
        return slot

    # -- fused decode chunk --------------------------------------------------
    def _chunk(self, block_table, last, lens, remaining, length=None):
        """``length`` (default ``sync_every``) decode steps with on-device
        argmax sampling; the done-mask freezes finished sequences (their
        writes land at their own frozen position, or the dump page once the
        slot is freed).  Every tensor stays on the device: nothing here
        waits for the card."""
        vocab = self.cfg.vocab_size
        toks = []
        for _ in range(self.sync_every if length is None else length):
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
        if self.spec_slots and all(
                req is None or slot in self.spec_slots
                for slot, req in enumerate(self.slot_req)):
            # every live slot is speculative: the pair rounds drive them,
            # so the frozen chunk would be pure wasted compute
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
            if req is None or slot in self.spec_slots:
                # spec slots ride the chunk frozen (remaining 0); the
                # server's pair rounds emit and complete them
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
        self._san_check()
        return finished

    def step(self) -> List[Request]:
        """One decode chunk for every active sequence (dispatch + collect)."""
        return self.step_end(self.step_begin())

    # -- speculative cascade plane ---------------------------------------------
    # Spec slots hold a normal slot + pages but are frozen for the chunk
    # loop (remaining stays 0, step_end skips them); the server's pair
    # rounds drive them through draft_round / verify_round below and advance
    # ``lens`` only by the accepted length.  Every position >= lens is
    # written by a round before anything attends to it, so rejected draft KV
    # is never read — pages past the accepted prefix go back to the
    # allocator each round (rollback_pages) and the next round's
    # ensure_pages allocates them afresh.

    def can_serve_spec(self, req: Request, k: int) -> bool:
        """Spec variant of :meth:`can_serve`: the draft overshoots up to
        ``k - 1`` positions past the last accepted token."""
        return len(req.tokens) - 1 + req.max_new + k - 1 <= self.t_max

    def admit_spec(self, req: Request, k: int) -> int:
        """Admit a speculative sequence: normal admission (prefill into
        pages), then freeze the slot and mark it spec-driven."""
        if self._has_recurrent or not self._has_kv:
            raise NotImplementedError(
                "speculative decode needs rollback-able paged KV "
                "(pure-attention models only)")
        if not self.can_serve_spec(req, k):
            raise ValueError(f"request {req.rid} + draft window {k} "
                             f"exceeds t_max={self.t_max}")
        slot = self.admit(req)
        self.remaining[slot] = 0
        self.spec_slots.add(slot)
        return slot

    def release_spec(self, slot: int):
        """Free a finished speculative slot through the normal paths."""
        self._free_slot(slot)
        self.lens[slot] = 0
        self.last_tokens[slot, 0] = 0
        self._san_check()

    def ensure_pages(self, slot: int, n_tokens: int):
        """Grow a spec slot's coverage to ``n_tokens`` positions before a
        round writes them (the inverse of :meth:`rollback_pages`)."""
        need = -(-n_tokens // self.page_size)
        have = len(self._slot_pages[slot])
        if need > have:
            pages = self.alloc.alloc_pages(need - have)
            self._slot_pages[slot].extend(pages)
            self.block_table[slot, have:need] = pages
            self._san_check()

    def rollback_pages(self, slot: int, n_tokens: int):
        """Release the pages that hold ONLY rejected draft positions (past
        the accepted prefix of ``n_tokens``) back to the allocator."""
        keep = -(-n_tokens // self.page_size)
        pages = self._slot_pages[slot]
        if len(pages) > keep:
            self.alloc.release_pages(pages[keep:])
            self.block_table[slot, keep:len(pages)] = 0
            del pages[keep:]
            self._san_check()

    def draft_round(self, slot_tokens: dict, k: int) -> np.ndarray:
        """Draft ``k`` tokens for every slot in ``slot_tokens`` (slot ->
        pending token) in one k-step chunk over the full fixed batch.  Other
        slots ride along frozen (remaining 0): their writes land at their own
        frozen position, which the next chunk or round rewrites before
        anything attends to it.  Returns the (L, k) drafted tokens (one host
        sync); host mirrors are untouched — acceptance decides the advance."""
        last = self.last_tokens.copy()
        rem = np.zeros_like(self.remaining)
        for slot, tok in slot_tokens.items():
            last[slot, 0] = tok
            rem[slot] = k
        dev = self.device
        out = self._chunk(_to_device(self.block_table, dev),
                          _to_device(last, dev), _to_device(self.lens, dev),
                          _to_device(rem, dev), length=k)
        self.busy_steps += 1
        return out[3].cpu().numpy()

    def _verify(self, tokens, block_table, lens, spec_mask, remaining):
        """One verify round on the device: all k positions in ONE batched
        paged verify step, acceptance included.  Returns the (B, k + 2)
        int32 tensor [strong tokens (k) | n_emit | pending]."""
        _, logits = self.model.verify_step_paged(
            self.params, self._state, tokens, block_table, lens)
        strong = torch.argmax(logits[:, :, :self.cfg.vocab_size],
                              dim=-1).to(torch.int32)            # (B, k)
        # tokens[:, 1:] are the draft continuations d_1..d_{k-1}; draft
        # position j survives iff it equals the strong argmax s_{j-1}
        matches = (tokens[:, 1:] == strong[:, :-1]).to(torch.int32)
        prefix = torch.cumprod(matches, dim=1).sum(dim=1)       # (B,)
        # accepted prefix + the strong correction token, clamped by the
        # per-sequence output budget
        n_emit = torch.minimum(prefix + 1, torch.clamp(remaining, min=1))
        n_emit = torch.where(spec_mask, n_emit, 0).to(torch.int32)
        idx = torch.clamp(n_emit - 1, min=0).long()
        pending = strong.gather(1, idx[:, None])
        return torch.cat([strong, n_emit[:, None], pending], dim=1)

    def verify_round(self, slot_tokens: dict, slot_rem: dict, k: int):
        """Verify every spec slot's k draft positions in one batched
        multi-position paged step.  Non-spec rows are masked to the dump
        page (block table 0, len 0) so their k-position writes never touch
        live pages.  Returns host (strong (L, k), n_emit (L,), pending (L,))
        from a single device-to-host transfer."""
        toks = np.zeros((self.L, k), np.int32)
        mask = np.zeros((self.L,), bool)
        rem = np.zeros((self.L,), np.int32)
        for slot, tv in slot_tokens.items():
            toks[slot] = tv
            mask[slot] = True
            rem[slot] = slot_rem[slot]
        bt = np.where(mask[:, None], self.block_table, 0).astype(np.int32)
        lens = np.where(mask, self.lens, 0).astype(np.int32)
        dev = self.device
        out = self._verify(_to_device(toks, dev), _to_device(bt, dev),
                           _to_device(lens, dev), _to_device(mask, dev),
                           _to_device(rem, dev)).cpu().numpy()
        self.busy_steps += 1
        return out[:, :k], out[:, k], out[:, k + 1]


class RestartEndpoint:
    """The reference's restart-based batching, kept as the baseline: every
    admit and completion re-prefills the *entire* packed batch (left-padded
    to the longest sequence, whose cost every sequence pays), grows the
    cache by ``t_max`` positions (``zoo.pad_cache``) and decodes one token
    per step with ``DecoderLM.decode_step`` over the dense cache.  The left
    pads are token-0 positions that every step attends, as in the
    reference.  ``params`` replaces the random init from ``seed``; the
    cache lives on ``device`` (CUDA unless named)."""

    def __init__(self, cfg: ModelConfig, *, max_concurrency: int = 4,
                 t_max: int = 128, seed: int = 0, params=None, device=None):
        if cfg.family == "encdec":
            # the reference's admission re-prefills without the encoder's
            # frames and fails there; refused here before any state is made
            raise NotImplementedError(
                "restart batching re-prefills token prompts; the enc-dec "
                "family needs frame embeddings that no request carries")
        self.cfg = cfg
        self.device = default_device(device)
        self.L = max_concurrency
        self.t_max = t_max
        self.model = build_model(cfg)
        self.params = (self.model.init(seed, self.device) if params is None
                       else params)
        self.active: List[Request] = []
        self._cache = None
        self._last_tokens = None
        self.busy_steps = 0          # decode steps dispatched
        self.decoded_tokens = 0
        self.prefill_calls = 0       # one batched prefill per rebuild
        self.batch_reprefills = 0    # rebuilds of the whole batch

    def active_count(self) -> int:
        return len(self.active)

    def has_capacity(self) -> bool:
        return len(self.active) < self.L

    def active_requests(self) -> List[Request]:
        return list(self.active)

    def cancel(self, req: Request) -> bool:
        """Drop a still-decoding request; the survivors pay one more
        re-prefill."""
        for k, r in enumerate(self.active):
            if r is req:
                self.active.pop(k)
                self._rebuild()
                return True
        return False

    def admit(self, req: Request):
        """Merge the request into the active batch by re-prefilling the
        whole packed batch."""
        if not self.has_capacity():
            raise RuntimeError("admit on a full endpoint")
        req.started = time.perf_counter()
        req.output = []
        self.active.append(req)
        self._rebuild()

    def _rebuild(self):
        if not self.active:
            self._cache = None
            return
        self.batch_reprefills += 1
        self.prefill_calls += 1
        maxlen = max(len(r.tokens) + len(r.output or []) for r in self.active)
        toks = np.zeros((len(self.active), maxlen), np.int32)
        for i, r in enumerate(self.active):
            seq = list(r.tokens) + list(r.output or [])
            toks[i, -len(seq):] = seq  # left-pad
        cache, _ = self.model.prefill(self.params,
                                      _to_device(toks[:, :-1], self.device))
        self._cache = pad_cache(cache, maxlen - 1 + self.t_max)
        self._last_tokens = _to_device(toks[:, -1:], self.device)

    def step_begin(self):
        """Dispatch one batched decode step (async) — does not block."""
        if not self.active:
            return None
        self._cache, logits = self.model.decode_step(
            self.params, self._cache, self._last_tokens)
        self.busy_steps += 1
        return logits

    def step_end(self, logits) -> List[Request]:
        """Read the step's greedy tokens, emit them, and rebuild the batch
        if any request finished."""
        if logits is None:
            return []
        nxt = torch.argmax(logits[:, :self.cfg.vocab_size],
                           dim=-1).to(torch.int32)
        self._last_tokens = nxt[:, None]
        host = nxt.cpu().numpy()
        self.decoded_tokens += len(self.active)
        finished, keep = [], []
        for i, r in enumerate(self.active):
            r.output.append(int(host[i]))
            if len(r.output) >= r.max_new:
                r.done = True
                r.finished = time.perf_counter()
                finished.append(r)
            else:
                keep.append(r)
        if finished:
            self.active = keep
            self._rebuild()
        return finished

    def step(self) -> List[Request]:
        """One batched decode step for every active sequence."""
        return self.step_end(self.step_begin())


def _can_serve(ep, req: Request) -> bool:
    """Whether ``ep`` can ever fit ``req`` (an endpoint without fixed
    shapes, the restart baseline, fits every request)."""
    return getattr(ep, "can_serve", lambda r: True)(req)


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
        self.requeue = None       # bound by ControlLoop: (req, at_step)
        self._progress: dict = {}  # id(req) -> (req, len(output), step) for
        #                            the stranded-request watchdog

    def now(self) -> float:
        return float(self.steps)

    def loads(self) -> np.ndarray:
        srv = self.server
        vals = [float(e.L) for e in srv.endpoints]
        if srv.spec_pairs:
            pc = srv._pair_counts()
            for p, pair in enumerate(srv.spec_pairs):
                d_ep = srv.endpoints[pair.draft]
                v_ep = srv.endpoints[pair.verify]
                free = min(d_ep.L - d_ep.active_count(),
                           v_ep.L - v_ep.active_count())
                # a pair column can take min(free on both ends) MORE
                # sequences: report load so available == that headroom
                vals.append(float(pc[p] + free))
        return np.array(vals, float)

    def counts(self) -> np.ndarray:
        srv = self.server
        vals = [float(e.active_count()) for e in srv.endpoints]
        if srv.spec_pairs:
            vals.extend(float(c) for c in srv._pair_counts())
        return np.array(vals, float)

    def dispatch(self, items, x) -> List[Request]:
        rejected = []
        x = np.asarray(x)
        srv = self.server
        plan = srv.fault_plan
        h = srv.health
        t = float(self.steps)
        for req, j in zip(items, x):
            j = int(j)
            if j >= len(srv.endpoints):
                # pair column: admit onto BOTH the pair's endpoints
                pair = srv.spec_pairs[j - len(srv.endpoints)]
                d_ep = srv.endpoints[pair.draft]
                v_ep = srv.endpoints[pair.verify]
                if not (d_ep.can_serve_spec(req, pair.k)
                        and v_ep.can_serve_spec(req, pair.k)):
                    req.done = True
                    req.endpoint = j
                    req.output = []
                    req.finished = time.perf_counter()
                    srv.completed.append(req)
                elif d_ep.has_capacity() and v_ep.has_capacity():
                    req.admit_step = float(self.steps)
                    srv.admit_spec(req, j - len(srv.endpoints))
                else:
                    rejected.append(req)
                continue
            ep = srv.endpoints[j]
            if not _can_serve(ep, req):
                # can NEVER fit this endpoint's fixed shapes: fail it cleanly
                # instead of crashing the server or re-queueing forever
                req.done = True
                req.endpoint = j
                req.output = []
                req.finished = time.perf_counter()
                srv.completed.append(req)
                continue
            if h is not None and not h.admissible(j):
                rejected.append(req)    # breaker open / probes exhausted
                continue
            if plan is not None:
                cap = plan.rate_limit(j, t)
                if cap is not None and ep.active_count() >= cap:
                    # 429: shed the request back to the queue, health hears
                    if h is not None:
                        h.record(j, False, None, now=t)
                    rejected.append(req)
                    continue
                if plan.down(j, t):
                    # connect-time failure on a dead endpoint
                    if h is not None:
                        h.record(j, False, None, now=t)
                    self._retry_or_fail(req)
                    continue
            if ep.has_capacity():
                req.endpoint = j
                req.admit_step = float(self.steps)
                ep.admit(req)
                if h is not None:
                    h.note_admit(j)
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
        plan = self.server.fault_plan
        pending = []
        for i in self._pool_order(len(eps)):
            if plan is not None and self._fault_skips(i):
                pending.append((eps[i], None))      # faulted: chunk skipped
            else:
                pending.append((eps[i], eps[i].step_begin()))
        done: List[Request] = []
        progressed = False
        for e, p in pending:
            fin = e.step_end(p)
            progressed = progressed or bool(fin) or bool(e.active_count())
            done.extend(fin)
        if self.server._spec:
            # pair rounds after the normal chunks: every round emits at
            # least the strong model's correction token, so this always
            # progresses
            done.extend(self.server._spec_round())
            progressed = True
        self.steps += 1
        done = self._resolve_hedges(self._completion_order(done))
        h = self.server.health
        events = []                 # (endpoint, ok, latency, rid)
        if h is not None:
            for req in done:
                events.append((int(req.endpoint), True,
                               float(self.steps) - float(req.admit_step),
                               int(req.rid)))
        if plan is not None:
            self._apply_flakes(plan, events)
        if self.server.stall_after_chunks > 0:
            self._watchdog(events)
        if h is not None:
            # a fixed order: the EWMA folds do not commute, so the chunk's
            # events are sorted before they reach the breakers
            for j, ok, lat, _ in sorted(events):
                h.record(j, ok, lat if ok else None, now=float(self.steps))
        self.server.completed.extend(done)
        return done, progressed

    # -- ordering seams (identity here; a schedule race checker permutes
    # them to show that same-chunk completions, hedges and cancels
    # commute) ----------------------------------------------------------------
    def _pool_order(self, k: int):
        return range(k)

    def _completion_order(self, done: List[Request]) -> List[Request]:
        return done

    def _fault_candidates(self):
        return [(i, req) for i, ep in enumerate(self.server.endpoints)
                for req in ep.active_requests()]

    # -- fault injection (server.fault_plan; dormant when None) ----------------
    def _fault_skips(self, i: int) -> bool:
        """Whether endpoint ``i`` loses this decode chunk to a fault: a
        hard-down endpoint makes no progress at all; a latency spike of
        factor f advances one chunk in every f (so its effective service
        time stretches by f without touching the paged state)."""
        plan = self.server.fault_plan
        t = float(self.steps)
        if plan.down(i, t):
            return True
        f = plan.latency_factor(i, t)
        return f > 1.0 and self.steps % max(int(round(f)), 1) != 0

    def _apply_flakes(self, plan, events):
        """Transient errors mid-decode: each active request flips a coin
        keyed on (endpoint, rid, step) — stateless, so the outcome is
        independent of sweep order and fresh every chunk."""
        t = float(self.steps)
        for i, req in self._fault_candidates():
            if req.rid in self.server._spec:
                continue    # spec sequences live outside the fault plane
            if plan.flake(i, t, req.rid, self.steps):
                if self.server.health is not None:
                    events.append((int(i), False, 0.0, int(req.rid)))
                self._fail_request(req)

    def _watchdog(self, events):
        """Stranded-request detector: a request whose output has not grown
        for ``stall_after_chunks`` chunks (its endpoint is dead or wedged)
        is cancelled through ``Endpoint.cancel`` — its slot and pages go
        back to the free lists — and retried elsewhere."""
        k = self.server.stall_after_chunks
        seen = set()
        for i, req in self._fault_candidates():
            if req.rid in self.server._spec:
                continue    # spec sequences live outside the fault plane
            seen.add(id(req))
            out_len = len(req.output or ())
            ent = self._progress.get(id(req))
            if ent is None or ent[0] is not req or ent[1] != out_len:
                self._progress[id(req)] = (req, out_len, self.steps)
                continue
            if self.steps - ent[2] >= k:
                del self._progress[id(req)]
                seen.discard(id(req))
                if self.server.health is not None:
                    events.append((int(i), False, 0.0, int(req.rid)))
                self._fail_request(req)
        for key in [key for key in self._progress if key not in seen]:
            del self._progress[key]    # completed/failed: stop tracking

    def _fail_request(self, req: Request):
        """Remove a live request from the pool after a fault.  A hedged
        pair fails as a unit (both copies cancelled, the primary retries);
        ``_resolve_hedges`` has run by then, so a pair in ``_hedges`` still
        has both copies in flight."""
        srv = self.server
        pair = srv._hedges.pop(req.rid, None)
        if pair is not None:
            primary, pi, shadow, si = pair
            srv.endpoints[pi].cancel(primary)
            srv.endpoints[si].cancel(shadow)
            srv._shadow_ids.discard(id(shadow))
            self._retry_or_fail(primary)
            return
        if id(req) in srv._shadow_ids:
            srv._shadow_ids.discard(id(req))
            for ep in srv.endpoints:
                if ep.cancel(req):
                    break
            return                  # the primary carries the retry
        if not any(ep.cancel(req) for ep in srv.endpoints):
            return                  # already cancelled earlier this sweep
        self._retry_or_fail(req)

    def _retry_or_fail(self, req: Request):
        """Retry with exponential backoff while budget remains, else mark
        the request permanently failed."""
        srv = self.server
        req.retries += 1
        req.endpoint = -1
        req.hedged = False
        req.done = False
        req.output = None
        if req.retries <= srv.retry_budget and self.requeue is not None:
            srv.retries += 1
            back = srv.backoff_steps * (2.0 ** (req.retries - 1))
            self.requeue(req, float(self.steps) + back)
        else:
            req.done = True
            req.failed = True
            req.output = []
            req.finished = time.perf_counter()
            srv.failures += 1
            srv.completed.append(req)

    def tick(self):
        """The loop's post-event hook: fire the hedge policy.  It runs
        between chunks, after ``advance`` has synced every endpoint, so
        cancelling or duplicating a slot races nothing."""
        self._maybe_hedge()

    # -- hedging (the simulator's semantics on the engine clock) ---------------
    def _pick_alt(self, primary: int, req: Request) -> Optional[int]:
        """Least-loaded endpoint other than the primary that has a free slot
        and fits the request's shapes."""
        best, best_free = None, 0
        h = self.server.health
        for j, ep in enumerate(self.server.endpoints):
            free = ep.L - ep.active_count()
            if (j != primary and free > best_free and ep.has_capacity()
                    and (h is None or h.admissible(j))
                    and _can_serve(ep, req)):
                best, best_free = j, free
        return best

    def _hedge_candidates(self):
        return [(i, req) for i, ep in enumerate(self.server.endpoints)
                for req in ep.active_requests()]

    def _maybe_hedge(self):
        """Duplicate un-hedged slow decodes: a request still in flight
        ``hedge_after`` chunks past admission gets a sibling copy admitted
        on the least-loaded other endpoint.  First finisher wins; the
        straggler is cancelled at resolution (``_resolve_hedges``)."""
        srv = self.server
        if srv.hedge_after <= 0:
            return
        for i, req in self._hedge_candidates():
            if (req.hedged or req.done or req.rid in srv._spec
                    or self.steps - req.admit_step < srv.hedge_after):
                continue
            alt = self._pick_alt(i, req)
            if alt is None:
                continue
            shadow = dataclasses.replace(
                req, output=None, done=False, endpoint=alt, hedged=True,
                admit_step=float(self.steps))
            req.hedged = True
            srv._shadow_ids.add(id(shadow))
            srv._hedges[req.rid] = (req, i, shadow, alt)
            srv.endpoints[alt].admit(shadow)
            if srv.health is not None:
                srv.health.note_admit(alt)
            srv.hedged += 1

    def _resolve_hedges(self, done: List[Request]) -> List[Request]:
        """First finisher wins: report the PRIMARY request (with the
        winner's output and endpoint) exactly once and cancel the
        straggler sibling, freeing its slot at once."""
        srv = self.server
        if not srv._hedges and not srv._shadow_ids:
            return done
        out: List[Request] = []
        for req in done:
            pair = srv._hedges.get(req.rid)
            if pair is None or (req is not pair[0] and req is not pair[2]):
                if id(req) in srv._shadow_ids:
                    srv._shadow_ids.discard(id(req))
                    continue            # sibling already resolved: drop copy
                out.append(req)
                continue
            primary, pi, shadow, si = pair
            del srv._hedges[req.rid]
            if req is shadow:
                srv._shadow_ids.discard(id(shadow))
                if primary.done:        # tie (same chunk): primary's own
                    continue            # completion stands, drop the copy
                srv.endpoints[pi].cancel(primary)
                primary.output = shadow.output
                primary.endpoint = shadow.endpoint
                primary.done = True
                primary.finished = shadow.finished
                out.append(primary)
            else:                       # primary won: kill the shadow
                if not shadow.done:
                    srv.endpoints[si].cancel(shadow)
                    srv._shadow_ids.discard(id(shadow))
                out.append(req)
        return out


class MultiLLMServer:
    """Router + endpoint pool behind the streaming control loop: admission
    per the paper's capacity rule, arrival-step release, routing windows
    rate-limited to one per ``window_steps`` decode steps (unless a full
    batch is waiting) and resized by ``adapt_window`` (a
    ``core.control.AdaptiveWindow``), with ``stream=True`` a persistent
    dual state through ``policy.route_window`` (``horizon`` is the stream
    length a stateful policy spreads its budget over; 0 = the queue at the
    first ``run``), and with ``spec_pairs`` the speculative cascade plane
    (they must match the policy's ``RouterConfig.spec_pairs`` when the
    policy is an ``OmniRouter``).

    The failure plane (see the module docstring): ``hedge_after_steps``,
    ``fault_plan``, ``health`` (``True`` builds a ``HealthTracker`` over
    the endpoints), ``retry_budget``, ``backoff_steps`` and
    ``stall_after_chunks``; ``fold_online`` folds completions into the
    policy's store every ``fold_chunk`` requests (0 = ``batch_size``).
    ``failures``, ``retries``, ``hedged`` and ``folded`` count what the
    plane did."""

    # executor factory, overridable per instance (a schedule race checker
    # swaps in an executor that permutes its ordering seams)
    _executor_cls = _EngineExecutor

    def __init__(self, endpoints: List[Endpoint], policy, *,
                 batch_size: int = 0, hedge_after_steps: int = 0,
                 fold_online: bool = False, fold_chunk: int = 0,
                 stream: bool = False, horizon: int = 0,
                 window_steps: float = 0.0, fault_plan=None, health=None,
                 retry_budget: int = 2, backoff_steps: float = 4.0,
                 stall_after_chunks: int = 0, spec_pairs=(),
                 adapt_window=None):
        self.endpoints = endpoints
        self.policy = policy
        cap = sum(e.L for e in endpoints)
        self.rule = AdmissionRule(batch_size).resolve(cap)
        self.batch_size = self.rule.batch_size
        self.max_inflight = self.rule.max_inflight
        self.hedge_after = hedge_after_steps
        self.fold_online = fold_online
        self.fold_chunk = fold_chunk or self.batch_size
        self.stream = stream
        self.horizon = horizon
        self.window_steps = window_steps
        self.fault_plan = fault_plan         # serving.faults.FaultPlan
        if health is True:
            health = HealthTracker(len(endpoints))
        self.health = health                 # core.health.HealthTracker
        self.retry_budget = retry_budget
        self.backoff_steps = backoff_steps   # retry k waits 2^(k-1) x this
        self.stall_after_chunks = stall_after_chunks
        self.adapt_window = adapt_window     # core.control.AdaptiveWindow
        self.spec_pairs = tuple(spec_pairs)
        self._spec: dict = {}       # rid -> _SpecSeq
        self.spec_rounds = 0        # per-sequence verify rounds run
        self.spec_emitted = 0       # tokens emitted by the spec plane
        if self.spec_pairs:
            if self.health is not None:
                raise NotImplementedError(
                    "speculative pair columns extend loads/counts past the "
                    "health plane's model axis; run spec pools without "
                    "health")
            for p in self.spec_pairs:
                for j in (p.draft, p.verify):
                    ep = endpoints[j]
                    if getattr(ep, "_has_recurrent", True) \
                            or not getattr(ep, "_has_kv", False):
                        raise NotImplementedError(
                            f"pair endpoint {j} ({ep.cfg.name}) is not a "
                            f"pure-attention paged endpoint; speculative "
                            f"decode needs rollback-able paged KV")
        self.failures = 0                    # requests failed past the budget
        self.retries = 0                     # attempts re-entered the queue
        self.queue: deque = deque()     # (arrival_step, Request)
        self.completed: List[Request] = []
        self._fold_buf: List[Request] = []   # direct fold-back entry point
        self.folded = 0
        self.route_calls = 0
        self.route_seconds = 0.0
        self.windows = 0
        self.dual_iters = 0
        self.hedged = 0                      # hedge duplicates fired
        self._hedges: dict = {}              # rid -> (primary, i, shadow, j)
        self._shadow_ids: set = set()        # id() of live shadow copies
        self._controller: Optional[StreamController] = None

    def submit(self, req: Request, at_step: float = 0.0):
        """Queue a request; ``at_step`` releases it into the stream once
        the engine clock (decode chunk index) reaches it.  A request NO
        endpoint can fit is failed here, before it is ever routed."""
        req.submitted = time.perf_counter()
        if self.endpoints and not any(_can_serve(ep, req)
                                      for ep in self.endpoints):
            req.done = True
            req.output = []
            req.finished = time.perf_counter()
            self.completed.append(req)
            return
        self.queue.append((float(at_step), req))

    # -- speculative cascade plane ---------------------------------------------
    def _pair_counts(self) -> List[int]:
        counts = [0] * len(self.spec_pairs)
        for s in self._spec.values():
            counts[s.pair] += 1
        return counts

    def admit_spec(self, req: Request, pair_idx: int):
        """Admit one request speculatively: a slot + prompt prefill on BOTH
        the pair's endpoints, driven by :meth:`_spec_round` from then on."""
        pair = self.spec_pairs[pair_idx]
        d_slot = self.endpoints[pair.draft].admit_spec(req, pair.k)
        v_slot = self.endpoints[pair.verify].admit_spec(req, pair.k)
        req.endpoint = len(self.endpoints) + pair_idx
        plen = len(req.tokens) - 1
        self._spec[req.rid] = _SpecSeq(
            req=req, pair=pair_idx, d_slot=d_slot, v_slot=v_slot,
            pending=int(req.tokens[-1]), base=plen, remaining=req.max_new)

    def _spec_round(self) -> List[Request]:
        """One draft+verify round for every live speculative sequence,
        batched per pair: the draft endpoint decodes k tokens in one k-step
        chunk, the verify endpoint scores all k positions in ONE batched
        multi-position paged step, and the longest strong-matching prefix
        plus the strong correction token is emitted.  Emissions are always
        strong-model argmaxes, so spec output equals decoding on the verify
        endpoint alone.  Rejected draft pages roll back through the
        allocator; acceptance feeds the router's ``AcceptanceTracker``.
        Two host syncs per pair: the draft tokens and the verify result."""
        finished: List[Request] = []
        acc = getattr(self.policy, "acceptance", None)
        for p, pair in enumerate(self.spec_pairs):
            seqs = [s for s in self._spec.values() if s.pair == p]
            if not seqs:
                continue
            d_ep = self.endpoints[pair.draft]
            v_ep = self.endpoints[pair.verify]
            k = pair.k
            for s in seqs:
                d_ep.ensure_pages(s.d_slot, s.base + k)
                v_ep.ensure_pages(s.v_slot, s.base + k)
            draft = d_ep.draft_round({s.d_slot: s.pending for s in seqs}, k)
            v_tokens, v_rem = {}, {}
            for s in seqs:
                row = np.empty((k,), np.int32)
                row[0] = s.pending
                row[1:] = draft[s.d_slot, :k - 1]
                v_tokens[s.v_slot] = row
                v_rem[s.v_slot] = s.remaining
            strong, n_emit, pending = v_ep.verify_round(v_tokens, v_rem, k)
            for s in seqs:
                ne = int(n_emit[s.v_slot])
                s.req.output.extend(int(t) for t in strong[s.v_slot, :ne])
                v_ep.decoded_tokens += ne
                s.base += ne
                s.remaining -= ne
                s.pending = int(pending[s.v_slot])
                d_ep.lens[s.d_slot] = s.base
                v_ep.lens[s.v_slot] = s.base
                d_ep.last_tokens[s.d_slot, 0] = s.pending
                v_ep.last_tokens[s.v_slot, 0] = s.pending
                d_ep.rollback_pages(s.d_slot, s.base)
                v_ep.rollback_pages(s.v_slot, s.base)
                if acc is not None:
                    acc.record(p, ne)
                self.spec_rounds += 1
                self.spec_emitted += ne
                if s.remaining <= 0:
                    req = s.req
                    req.done = True
                    req.finished = time.perf_counter()
                    d_ep.release_spec(s.d_slot)
                    v_ep.release_spec(s.v_slot)
                    del self._spec[req.rid]
                    finished.append(req)
        return finished

    def _fold(self, route_features, *, force: bool = False):
        """Fold ``_fold_buf`` into the policy's store — the manual entry
        point for completions that did not flow through :meth:`run` (the
        loop folds its own through a :class:`FoldBuffer`)."""
        if not self.fold_online or not self._fold_buf:
            return
        if not force and len(self._fold_buf) < self.fold_chunk:
            return
        if fold_completions(self.policy, route_features(self._fold_buf),
                            np.arange(len(self._fold_buf))):
            self.folded += len(self._fold_buf)
        self._fold_buf.clear()

    def run(self, route_features, *, max_steps: int = 10_000):
        # ONE controller for the server's lifetime: a stream's dual state
        # must survive across run() calls
        if self._controller is None:
            self._controller = StreamController(
                self.policy, horizon=self.horizon or len(self.queue),
                stream=self.stream, health=self.health,
                adapt_window=self.adapt_window)
        controller = self._controller
        windows0 = controller.windows
        iters0 = controller.dual_iters
        fold = FoldBuffer(self.policy, route_features,
                          enabled=self.fold_online, chunk=self.fold_chunk)
        items = [req for _, req in self.queue]
        times = np.array([t for t, _ in self.queue])
        self.queue.clear()
        executor = self._executor_cls(self, max_steps)
        loop = ControlLoop(
            executor=executor, controller=controller, rule=self.rule,
            items=items, features=route_features, fold=fold,
            arrival_times=times, window=self.window_steps,
            drain_admissions=False, requeue_front=True, health=self.health)
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
        self.folded += fold.folded
        self.windows += controller.windows - windows0
        self.dual_iters += controller.dual_iters - iters0
        return self.completed
