"""Runtime guards of the port: the counterpart of ``repro.common.guards``.

* :class:`CompileGuard` — asserts a bounded number of NEW one-time compile
  events across a region.  The port has no jit: its compile events are the
  kernel builds (one ``nvcc`` each) and library loads of
  ``repro_torch.kernels._build``, and CUDA-graph captures that a caller
  records with :func:`record_compile`.  They go into one process-wide
  counter (:func:`global_compile_count`).
* :func:`no_host_sync` — on the card, ``torch.cuda.set_sync_debug_mode
  ("error")`` for the region: any operation that waits for the device
  (``.item()``, ``bool(t)``, a copy to or from pageable host memory)
  raises.  :func:`device_get` is the explicit fetch, the counterpart of
  ``jax.device_get``: it lowers the mode around its own copy and counts the
  reads it makes.  Off an accelerator the guard is advisory, as in the
  reference.
* :func:`strict_numerics` — an operation whose tensor operands hold two
  different floating dtypes raises :class:`PromotionError` (Python scalars
  stay allowed, as JAX's weak types do; conversions are the explicit
  spelling); with ``debug_nans`` an operation whose floating output holds
  a NaN raises too, which reads every output on the host: a debug mode.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

_lock = threading.Lock()
_compile_events = 0

#: explicit device-to-host reads made through :func:`device_get`
host_reads = 0


def record_compile() -> None:
    """Count one one-time compile event: a kernel build, a library load, a
    CUDA-graph capture."""
    global _compile_events
    with _lock:
        _compile_events += 1


def global_compile_count() -> int:
    """Process-wide compile-event count (monotonic; read it as a delta)."""
    return _compile_events


class CompileGuard:
    """Assert that a region performs at most ``max_retraces`` compile
    events.

    Watch targets are objects exposing ``compile_count()``; with no targets
    the guard watches the process-wide counter (kernel builds, library
    loads and recorded graph captures).

    >>> with CompileGuard() as g:
    ...     second_pass()
    >>> g.retraces()
    0

    ``max_retraces=None`` only measures; any int raises ``AssertionError``
    on exit when exceeded.
    """

    def __init__(self, *watch, max_retraces: int | None = 0, label: str = ""):
        for obj in watch:
            if not callable(getattr(obj, "compile_count", None)):
                raise TypeError(f"CompileGuard watches objects with a "
                                f"compile_count() method, not {obj!r}")
        self.watch = watch
        self.max_retraces = max_retraces
        self.label = label
        self._before: list[int] | None = None

    def _counts(self) -> list[int]:
        if self.watch:
            return [int(o.compile_count()) for o in self.watch]
        return [global_compile_count()]

    def __enter__(self) -> "CompileGuard":
        self._before = self._counts()
        return self

    def retraces(self) -> int:
        assert self._before is not None, "CompileGuard not entered"
        return sum(self._counts()) - sum(self._before)

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None or self.max_retraces is None:
            return
        seen = self.retraces()
        if seen > self.max_retraces:
            what = self.label or "guarded region"
            raise AssertionError(
                f"CompileGuard: {what} compiled {seen} time(s), expected at "
                f"most {self.max_retraces} — a shape/dtype/static-arg is "
                "churning the jit cache (see staticcheck rule SC02)."
            )


def _sync_mode() -> int:
    """The current CUDA sync debug mode (0 without a card)."""
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.get_sync_debug_mode()


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return np.asarray(x)


def device_get(x):
    """Explicit device-to-host fetch of a tensor (or a list or tuple of
    them) as NumPy: allowed inside :func:`no_host_sync`, and counted in
    ``host_reads``."""
    global host_reads
    mode = _sync_mode()
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        out = _to_host(x)
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)
    host_reads += 1
    return out


@contextlib.contextmanager
def no_host_sync():
    """Disallow implicit host syncs inside the region (on the card).

    Explicit fetches through :func:`device_get` stay allowed: the point is
    to catch accidental syncs (``float(t)``, ``if t:``, a pageable copy),
    not to forbid reading results.  Without a card the guard does nothing:
    host and device are one."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class PromotionError(ValueError):
    """An operation mixed floating dtypes under :func:`strict_numerics`.
    (Not a ``TypeError``: PyTorch turns those from a binary operator into
    ``NotImplemented``.)"""


# explicit conversions: changing a dtype is how mixed precision is spelled
_CONVERSIONS = frozenset({torch.Tensor.to, torch.Tensor.type,
                          torch.Tensor.type_as, torch.Tensor.copy_})


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


class _StrictNumerics(TorchFunctionMode):
    def __init__(self, debug_nans: bool):
        super().__init__()
        self.debug_nans = debug_nans

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _CONVERSIONS:
            dtypes = {t.dtype for t in _tensors((args, kwargs))
                      if t.is_floating_point()}
            if len(dtypes) > 1:
                raise PromotionError(
                    f"strict_numerics: {getattr(func, '__name__', func)} "
                    f"mixes {sorted(str(d) for d in dtypes)}: implicit "
                    "promotion is off, convert explicitly")
        out = func(*args, **kwargs)
        if self.debug_nans:
            for t in _tensors(out):
                if t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"strict_numerics(debug_nans=True): "
                        f"{getattr(func, '__name__', func)} produced a NaN")
        return out


@contextlib.contextmanager
def strict_numerics(debug_nans: bool = False):
    """Strict dtype promotion (+ optional NaN checking) for a region."""
    with _StrictNumerics(debug_nans):
        yield
