"""repro_torch.analysis.staticcheck — the port's AST lint pass.

The twin of ``repro.analysis.staticcheck`` over ``src/repro_torch``: the
same findings, ignore comments and baseline ratchet, with rules in their
PyTorch form.

==== ===================================================================
SC01 host-sync: ``.item()`` / ``.tolist()`` / ``.cpu()``,
     ``torch.cuda.synchronize()``, ``float()/int()/bool()`` of a tensor
     and a Python branch on a tensor-valued ``torch.*`` call, in
     functions the call graph reaches from a kernel wrapper
     (``kernels/*/kernel.py``, ``kernels/*/ops.py``) or from a region
     under ``no_host_sync`` or a CUDA-graph capture.
SC03 kernel-contract: every ``kernels/<name>/`` ships ``kernel.py`` +
     ``ref.py`` (the plain version) + ``ops.py`` and a
     ``tests/test_torch_*.py`` names it; every library ``kernel.py``
     loads has a source under ``csrc/``; ``ops.py`` has no fallback (no
     ``try`` around a launch, no CUDA branch that reaches ``ref``).
SC06 allocator-discipline, SC07 ledger-discipline, SC09 health-state
     discipline, SC10 speculative-contract: as the reference's, over the
     port's classes of the same names.
==== ===================================================================

SC08 (the drain contract of the tests) is the reference's own check, which
already scans ``tests/test_torch_*.py``.  SC02 (jit static arguments),
SC04 (reductions over a sharded axis) and SC05 (the Pallas grid) have no
PyTorch form yet.  Suppress a finding with ``# staticcheck:
ignore[SC0x] -- reason`` on the flagged line or alone on the line above.
The CLI (``python -m repro_torch.analysis.staticcheck``) exits nonzero on
any finding beyond its baseline.  Standard library only.
"""
from __future__ import annotations

from .core import Finding, load_baseline, new_findings, scan, write_baseline

__all__ = ["Finding", "scan", "load_baseline", "new_findings", "write_baseline"]
