"""Heartbeat / straggler monitoring + the training-loop failure protocol.

On real fleets this wraps the JAX distributed runtime; offline the monitor is
driven by injected events so the restart/elastic protocol is testable:

  1. heartbeats stop for a pod   -> HealthMonitor reports the dead pod
  2. trainer aborts the step     -> restores the latest async checkpoint
  3. a new (possibly smaller) mesh is built -> elastic reshard (ft.checkpoint
     restore with new shardings) -> training resumes

Serving-side straggler mitigation (hedged requests) lives in
core.scheduler / serving.engine; this module provides the shared detector.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class HealthConfig:
    heartbeat_timeout_s: float = 10.0
    straggler_factor: float = 3.0     # x median step time


class HealthMonitor:
    def __init__(self, n_units: int, cfg: HealthConfig = HealthConfig()):
        self.cfg = cfg
        self.last_beat: Dict[int, float] = {i: time.time() for i in range(n_units)}
        self.step_times: List[float] = []

    def beat(self, unit: int, t: Optional[float] = None):
        self.last_beat[unit] = t if t is not None else time.time()

    def dead_units(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return [u for u, t in self.last_beat.items()
                if now - t > self.cfg.heartbeat_timeout_s]

    def record_step(self, seconds: float):
        self.step_times.append(seconds)
        if len(self.step_times) > 256:
            self.step_times.pop(0)

    def is_straggler(self, seconds: float) -> bool:
        if len(self.step_times) < 8:
            return False
        med = sorted(self.step_times)[len(self.step_times) // 2]
        return seconds > self.cfg.straggler_factor * med


class PodFailure(RuntimeError):
    def __init__(self, pods: List[int]):
        super().__init__(f"pods {pods} missed heartbeats")
        self.pods = pods
