"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C launcher and compiles on its own
into ``build/repro_torch/lib<name>-<hash>.so`` at the repository root (the
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags,
so an edited source never loads a stale library).  Nothing is built at
import: the first launch builds, or :func:`build_all` builds every source
at once, one ``nvcc`` per source, all started together.  A failed build
raises; there is no fallback.  Every ``nvcc`` started and every library
loaded is one compile event of ``repro_torch.common.guards``
(``CompileGuard`` counts them).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

from repro_torch.common import guards

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# IEEE division and square root everywhere (nvcc's defaults; never
# --use_fast_math).  The dual solve and the shard statistics also forbid FMA
# contraction: the reference rounds every multiply and add separately.
_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FLAGS: Dict[str, List[str]] = {
    "dual_solve": _COMMON + ["--fmad=false"],
    "flash_attention": _COMMON,
    "flash_attention_bwd": _COMMON,
    "paged_decode": _COMMON,
    "retrieval_vote": _COMMON,
    "shard_stats": _COMMON + ["--fmad=false"],
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(FLAGS[name]).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{tag}.so"


def _command(name: str, out: Path) -> List[str]:
    return [nvcc(), *FLAGS[name], "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=None) -> Dict[str, str]:
    """Compile every source that has no up-to-date library, in parallel.
    Returns each compiler's output (``-Xptxas -v`` register/smem report)."""
    names = list(FLAGS) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
        guards.record_compile()
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
            guards.record_compile()
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
