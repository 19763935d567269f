"""A reader of ``torch.profiler`` over one call of a function.

The port's stand-in for ``repro.analysis.hlo_static``: XLA's compiled
program lists its dots and bytes, eager PyTorch has no such program, so
the port reads what ran.  ``profile(fn)`` runs ``fn()`` once under the
profiler and returns, per kernel name, the device ms and the launches;
the total device ms; and the device's busy share of the timed window (the
union of the kernels' intervals over the wall time of ``fn()`` and the
synchronisation after it).  On a CUDA device it reads the device's
activity (kernels, copies, fills); with ``device="cpu"`` the same reader
reads the CPU's operators, which is how it runs without a card.

Each hand kernel's work comes from :mod:`repro_torch.analysis.kernel_work`;
a hand kernel's launches by name are its ``ops`` counter's launches times
the device kernels one launch makes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Tuple

import torch


@dataclasses.dataclass
class Profile:
    kernels: Dict[str, Tuple[float, int]]   # name -> (device ms, launches)
    total_ms: float                         # summed over every kernel
    busy_ms: float                          # the union of their intervals
    wall_ms: float                          # fn() and the sync after it

    @property
    def busy_share(self) -> float:
        return self.busy_ms / self.wall_ms if self.wall_ms > 0 else 0.0

    def launches(self, *parts: str) -> int:
        """Launches of the kernels whose names hold any of ``parts``."""
        return sum(n for name, (_, n) in self.kernels.items()
                   if any(p in name for p in parts))

    def ms(self, *parts: str) -> float:
        """Device ms of the kernels whose names hold any of ``parts``."""
        return sum(ms for name, (ms, _) in self.kernels.items()
                   if any(p in name for p in parts))

    def top(self, n: int = 8) -> List[Tuple[str, float, int]]:
        """The ``n`` kernels with the most device ms: (name, ms, launches)."""
        rows = sorted(((name, ms, k) for name, (ms, k)
                       in self.kernels.items()), key=lambda r: -r[1])
        return rows[:n]


def _union_us(spans: Iterable[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def profile(fn: Callable[[], object], device="cuda") -> Profile:
    """Run ``fn()`` once under ``torch.profiler`` and read its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    on_cpu = torch.device(device).type == "cpu"
    activity = ProfilerActivity.CPU if on_cpu else ProfilerActivity.CUDA
    want = DeviceType.CPU if on_cpu else DeviceType.CUDA
    with torch.profiler.profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        fn()
        if not on_cpu:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    kernels: Dict[str, Tuple[float, int]] = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != want or ev.name.startswith("["):
            continue
        lo, hi = ev.time_range.start, ev.time_range.end
        ms, n = kernels.get(ev.name, (0.0, 0))
        kernels[ev.name] = (ms + (hi - lo) / 1e3, n + 1)
        spans.append((lo, hi))
    return Profile(kernels=kernels,
                   total_ms=sum(ms for ms, _ in kernels.values()),
                   busy_ms=_union_us(spans) / 1e3, wall_ms=wall * 1e3)
