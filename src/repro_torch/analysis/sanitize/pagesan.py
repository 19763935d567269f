"""PageSan: a shadow allocator for the paged serving engine.

Mirrors ``PageAllocator``'s free lists in O(1) sets, is fed by hooks on
every alloc/release (``PageAllocator`` calls them when ``alloc.san`` is not
None — the *only* cost when off is that None check), and cross-checks the
full ``Endpoint`` page/slot state after every admit/cancel/step.

What it certifies, beyond the allocator's own asserts (which it also
re-proves independently, so it still fires under ``python -O``):

* **double-free** — a page/slot released while already on the free list;
* **use-after-free** — a *live* slot's block-table row referencing a page
  the allocator considers free;
* **cross-slot aliasing** — one physical page wired into two live rows;
* **dump-page discipline** — page 0 is never handed out, never appears in
  a live row, and a live slot's *next write position* never resolves to it
  (freed slots' rows are zeroed ON PURPOSE so their masked in-flight
  writes land there — that is the contract, not a violation);
* **conservation / drain** — live pages + free pages account for the whole
  pool minus the dump page at every check, and :meth:`assert_drained`
  proves the pool returns to pristine after the last completion.
"""
from __future__ import annotations

from typing import Iterable, List, Optional


class PageSanError(AssertionError):
    """A paged-allocator invariant was violated (shadow allocator proof)."""


class PageSan:
    def __init__(self, alloc, endpoint=None, label: str = ""):
        self.alloc = alloc
        self.ep = endpoint
        self.label = label or (getattr(getattr(endpoint, "cfg", None),
                                       "name", "") if endpoint else "")
        # shadow copies — deliberately NOT aliases of the allocator's lists
        self.shadow_free_pages = set(alloc.free_pages)
        self.shadow_free_slots = set(alloc.free_slots)
        self.n_pages = alloc.n_pages
        self.n_slots = alloc.n_slots

    @classmethod
    def attach(cls, endpoint) -> "PageSan":
        """Wire a shadow onto a (quiescent) endpoint's allocator."""
        san = cls(endpoint.alloc, endpoint)
        endpoint.alloc.san = san
        return san

    def _fail(self, msg: str):
        where = f" [{self.label}]" if self.label else ""
        raise PageSanError(f"PageSan{where}: {msg}")

    # -- allocator hooks (called by PageAllocator when attached) -------------
    def on_alloc_pages(self, pages: Iterable[int]):
        from . import counters
        counters["events"] += 1
        for p in pages:
            if p == 0:
                self._fail("dump page 0 handed out by the allocator")
            if p not in self.shadow_free_pages:
                self._fail(f"allocated page {p} that the shadow does not "
                           f"consider free (corrupted free list / aliasing)")
            self.shadow_free_pages.discard(p)

    def on_release_pages(self, pages: Iterable[int]):
        from . import counters
        counters["events"] += 1
        for p in pages:
            if not (0 < p < self.n_pages):
                self._fail(f"released out-of-range page {p} "
                           f"(pool has pages 1..{self.n_pages - 1})")
            if p in self.shadow_free_pages:
                self._fail(f"double-free of page {p}")
            self.shadow_free_pages.add(p)

    def on_alloc_slot(self, slot: int):
        from . import counters
        counters["events"] += 1
        if slot not in self.shadow_free_slots:
            self._fail(f"allocated slot {slot} that is not free")
        self.shadow_free_slots.discard(slot)

    def on_release_slot(self, slot: int):
        from . import counters
        counters["events"] += 1
        if not (0 <= slot < self.n_slots):
            self._fail(f"released out-of-range slot {slot}")
        if slot in self.shadow_free_slots:
            self._fail(f"double-free of slot {slot}")
        self.shadow_free_slots.add(slot)

    # -- whole-state checks ---------------------------------------------------
    def _check_alloc_consistency(self):
        """The allocator's host lists must agree with the shadow — catches
        free-list mutation that bypassed the PageAllocator methods (the
        runtime twin of staticcheck SC06)."""
        a = self.alloc
        if len(a.free_pages) != len(self.shadow_free_pages) \
                or set(a.free_pages) != self.shadow_free_pages:
            self._fail("free_pages diverged from the shadow (mutated outside "
                       "PageAllocator, or a duplicate entry)")
        if len(a.free_slots) != len(self.shadow_free_slots) \
                or set(a.free_slots) != self.shadow_free_slots:
            self._fail("free_slots diverged from the shadow (mutated outside "
                       "PageAllocator, or a duplicate entry)")
        stale = self.shadow_free_pages - getattr(a, "_free_page_set",
                                                 self.shadow_free_pages)
        extra = getattr(a, "_free_page_set",
                        self.shadow_free_pages) - self.shadow_free_pages
        if stale or extra:
            self._fail(f"allocator's O(1) membership set out of sync "
                       f"(missing {sorted(stale)}, extra {sorted(extra)})")

    def check_endpoint(self, ep=None):
        """Full page/slot audit of an endpoint between decode chunks."""
        from . import counters
        counters["events"] += 1
        ep = ep if ep is not None else self.ep
        if ep is None:
            self._check_alloc_consistency()
            return
        self._check_alloc_consistency()

        live = {s for s, r in enumerate(ep.slot_req) if r is not None}
        both = live & self.shadow_free_slots
        if both:
            self._fail(f"slot(s) {sorted(both)} are live AND on the free "
                       f"list (use-after-free)")
        leaked = set(range(ep.L)) - live - self.shadow_free_slots
        if leaked:
            self._fail(f"leaked slot(s) {sorted(leaked)}: not live, not free")

        if not ep._has_kv:
            return

        owner = {}
        for s in sorted(live):
            pages: List[int] = ep._slot_pages[s]
            row = ep.block_table[s]
            if row[:len(pages)].tolist() != list(pages) \
                    or (row[len(pages):] != 0).any():
                self._fail(f"block-table row of live slot {s} disagrees with "
                           f"its page list {pages}: {row.tolist()}")
            for p in pages:
                if p == 0:
                    self._fail(f"dump page 0 wired into live slot {s}")
                if p in self.shadow_free_pages:
                    self._fail(f"use-after-free: live slot {s} references "
                               f"freed page {p}")
                if p in owner:
                    self._fail(f"cross-slot aliasing: page {p} owned by "
                               f"slots {owner[p]} and {s}")
                owner[p] = s
            # speculative rollback discipline: releasing rejected draft
            # pages must never cut into the accepted prefix — a spec slot
            # keeps at least ceil(lens / page_size) pages between rounds
            if s in getattr(ep, "spec_slots", ()):
                need = -(-int(ep.lens[s]) // ep.page_size)
                if len(pages) < need:
                    self._fail(f"speculative rollback cut into the accepted "
                               f"prefix of slot {s}: {len(pages)} page(s) "
                               f"cannot cover {int(ep.lens[s])} tokens")
            # next token write must land on a real page while decoding
            if ep.remaining[s] > 0:
                wpos = int(ep.lens[s]) // ep.page_size
                if wpos >= ep.pages_per_slot or int(row[wpos]) == 0:
                    self._fail(f"dump-page violation: live slot {s} would "
                               f"write position {int(ep.lens[s])} onto page 0 "
                               f"(row={row.tolist()})")

        for s in sorted(set(range(ep.L)) - live):
            if (ep.block_table[s] != 0).any():
                self._fail(f"freed slot {s} retains a nonzero block-table row "
                           f"{ep.block_table[s].tolist()} — its masked "
                           f"in-flight writes would alias live pages")

        if len(owner) + len(self.shadow_free_pages) != self.n_pages - 1:
            unaccounted = (set(range(1, self.n_pages)) - set(owner)
                           - self.shadow_free_pages)
            self._fail(f"leaked page(s) {sorted(unaccounted)}: neither owned "
                       f"by a live slot nor free")

    def assert_drained(self, ep: Optional[object] = None):
        """After the last completion the pool must be pristine again:
        no live slots, every slot and every non-dump page back on the
        free lists."""
        ep = ep if ep is not None else self.ep
        self.check_endpoint(ep)
        if ep is not None:
            live = [s for s, r in enumerate(ep.slot_req) if r is not None]
            if live:
                self._fail(f"drain: slot(s) {live} still live")
        if len(self.shadow_free_slots) != self.n_slots:
            self._fail(f"drain: {self.n_slots - len(self.shadow_free_slots)} "
                       f"slot(s) leaked")
        if len(self.shadow_free_pages) != self.n_pages - 1:
            self._fail(f"drain: {self.n_pages - 1 - len(self.shadow_free_pages)} "
                       f"page(s) leaked")
