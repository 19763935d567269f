"""Training data pipeline: deterministic synthetic token streams and
host-to-device placement one step ahead.

``synthetic_batches`` is a copy of ``repro.data.pipeline``'s (pure NumPy:
the same seed gives the same batches in both packages).  ``Prefetcher``
takes the reference's place of ``jax.device_put`` with a one-batch-ahead
queue: its thread copies each batch from pinned host memory to the device
on a CUDA stream of its own and records an event, which the consumer's
stream waits on before it uses the batch; on the CPU it places the arrays
as they are.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.common import default_device
from repro_torch.configs.base import ModelConfig, ShapeConfig


def synthetic_batches(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                      batch_override: Optional[int] = None,
                      seq_override: Optional[int] = None) -> Iterator[Dict]:
    """Infinite deterministic LM batches (token ids [+ frontend embeds])."""
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    step = 0
    while True:
        rng = np.random.RandomState((seed * 1_000_003 + step) % (2**31 - 1))
        out: Dict = {}
        if cfg.family == "encdec":
            out["embeds"] = rng.randn(b, s, cfg.d_model).astype(np.float32)
            out["tokens"] = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
        elif cfg.frontend != "none":
            flen = min(cfg.frontend_len, s // 2)
            out["embeds"] = rng.randn(b, flen, cfg.d_model).astype(np.float32)
            out["tokens"] = rng.randint(0, cfg.vocab_size,
                                        (b, s - flen)).astype(np.int32)
        else:
            out["tokens"] = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
        yield out
        step += 1


class Prefetcher:
    """Places the batches of ``it`` on ``device`` (CUDA unless named) up to
    ``depth`` steps ahead, on a thread of its own.  ``close`` stops it."""

    def __init__(self, it: Iterator[Dict], device=None, depth: int = 2):
        self.it = it
        self.device = default_device(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _place(self, batch):
        """(tensors on the device, the event their copies complete at)."""
        if self.stream is None:
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in batch.items()}, None
        with torch.cuda.stream(self.stream):
            out = {k: torch.from_numpy(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def _work(self):
        for batch in self.it:
            if self._stop.is_set():
                return
            self.q.put(self._place(batch))

    def __iter__(self):
        return self

    def __next__(self):
        out, done = self.q.get()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in out.values():
                # made on the side stream, used on this one
                t.record_stream(stream)
        return out

    def close(self):
        """Stop the thread: the flag, then free slots so a blocked ``put``
        returns and the loop sees the flag (within a minute, or raise)."""
        self._stop.set()
        deadline = time.monotonic() + 60.0
        while self.t.is_alive():
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self.t.join(timeout=0.05)
            if time.monotonic() > deadline:
                raise RuntimeError("the prefetch thread did not stop")
