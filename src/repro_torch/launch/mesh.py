"""Meshes of ranks, the harness that starts them, and their collectives.

The port of ``repro.launch.mesh``.  The reference lays a mesh over the
devices of one JAX program; the port runs one process a rank
(``torch.distributed``) and lays the mesh over the ranks: rank ``r`` sits at
the row-major coordinates of ``r`` in the mesh's shape, and the mesh holds
one process group for each line through this rank along each set of axes
(``Mesh.group``).  Collectives go through the wrappers below, which count
the bytes of their results by kind (``collective_stats``, read by
``repro_torch.analysis.roofline.collective_bytes``).  Every sum
(``all_reduce``, ``reduce_scatter``) adds the ranks' parts in group-rank
order, in one place (``_rank_sum``).

``run_ranks`` starts ``world`` ranks, each a fresh interpreter
(``python -m repro_torch.launch.mesh``), never a fork of the caller.  The
ranks meet through a ``file://`` store in a temporary directory, run one
thread each, write their results to files, and are killed together on
the timeout or on the first rank that fails.

The backend is named by the caller and is ``"gloo"``: NCCL refuses two
ranks on one card, and on one card the ranks share it.  A gloo collective
on a CUDA tensor is staged through host memory (copied to the host,
reduced or exchanged there, copied back), which these wrappers do; so a
time taken with ranks on one card is no multi-card time.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import importlib.util
import itertools
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

SRC = Path(__file__).resolve().parents[2]      # the directory of repro_torch
BACKENDS = ("gloo",)
KINDS = ("all-gather", "all-to-all", "all-reduce", "reduce-scatter",
         "send/recv", "broadcast")

# result bytes and calls of the collective wrappers below, by kind
_stats: Dict[str, list] = {k: [0, 0] for k in KINDS}


class Mesh:
    """A mesh of ranks: ``shape`` maps each axis name to its size (as the
    JAX ``Mesh.shape`` does), ``rank`` is this process's global rank.
    ``Mesh(shape, axis_names)`` alone is a mesh of a shape, with no rank
    and no process groups (for rule tables); ``Mesh.build`` lays one over
    the ranks of the initialised world."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: Optional[int] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = 1
        for s in self.shape.values():
            self.size *= s
        self.rank = rank
        self._groups = {}

    @classmethod
    def build(cls, shape, axis_names) -> "Mesh":
        """The mesh over every rank of the initialised world, which must
        have ``prod(shape)`` ranks.  Collective: every rank calls it, and
        it makes one ``dist.new_group`` per line of each set of axes, in
        the same order on every rank."""
        world = dist.get_world_size()
        mesh = cls(shape, axis_names, rank=dist.get_rank())
        if mesh.size != world:
            raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks, "
                             f"the world has {world}")
        names = mesh.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                for ranks in mesh._lines(axes):
                    group = dist.new_group(ranks)
                    if mesh.rank in ranks:
                        mesh._groups[axes] = (group, ranks)
        return mesh

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        # a set of axes is kept in the mesh's order (row-major lines)
        return tuple(a for a in self.axis_names if a in axes)

    def _lines(self, axes):
        """The global ranks of every line along ``axes``, each in
        row-major order over those axes."""
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        rest = [a for a in self.axis_names if a not in axes]
        lines = []
        for fixed in itertools.product(*(range(self.shape[a])
                                          for a in rest)):
            base = sum(i * strides[a] for a, i in zip(rest, fixed))
            lines.append([base + sum(i * strides[a]
                                     for a, i in zip(axes, idx))
                          for idx in itertools.product(
                              *(range(self.shape[a]) for a in axes))])
        return lines

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        out, r = {}, self.rank
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def axis_size(self, axes) -> int:
        n = 1
        for a in self._axes(axes):
            n *= self.shape[a]
        return n

    def axis_index(self, axes) -> int:
        """This rank's row-major index along ``axes`` (the JAX
        ``lax.axis_index`` of an axis tuple)."""
        c, idx = self.coords, 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes):
        """The process group of this rank's line along ``axes``."""
        return self._groups[self._axes(axes)][0]

    def ranks_along(self, axes):
        """The global ranks of this rank's line along ``axes``, in the
        order of ``axis_index``."""
        return self._groups[self._axes(axes)][1]


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over the ranks (the world must have
    ``data * model`` of them)."""
    return Mesh.build((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The prescribed mesh: (16, 16) over ``("data", "model")``, or
    (2, 16, 16) over ``("pod", "data", "model")``.  Raises unless the
    world has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.build(shape, axes)


# --- collectives ------------------------------------------------------------

def reset_collectives() -> None:
    for v in _stats.values():
        v[0] = v[1] = 0


def collective_stats() -> Dict[str, int]:
    """Result bytes by kind since the last reset, and the count of calls
    (the reference's ``collective_bytes`` schema)."""
    out = {k: v[0] for k, v in _stats.items()}
    out["count"] = sum(v[1] for v in _stats.values())
    return out


def _note(kind: str, nbytes: int) -> None:
    _stats[kind][0] += nbytes
    _stats[kind][1] += 1


def _host(t: torch.Tensor) -> torch.Tensor:
    """The tensor gloo reduces: contiguous, on the host."""
    return t.detach().to("cpu").contiguous()


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0 in group-rank order
    (rank-major; the tiled JAX ``all_gather``).  A CUDA tensor is staged
    through host memory."""
    h = _host(t)
    parts = [torch.empty_like(h) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, h, group=group)
    out = torch.cat(parts)
    _note("all-gather", out.numel() * out.element_size())
    return out.to(t.device)


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``all_gather`` along ``dim``: the group's blocks concatenated along
    that dim in group-rank order (counted as one all-gather)."""
    if dim == 0:
        return all_gather(t, group)
    return all_gather(t.movedim(dim, 0), group).movedim(0, dim).contiguous()


def _rank_sum(parts) -> torch.Tensor:
    """The parts added in group-rank order, ((p0 + p1) + p2) + ...: the one
    order of every ordered cross-rank sum, the same on every rank and on
    every device."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's sum of ``t``, split along ``dim`` into one block per
    group rank: this rank's block.  Each rank sends block i to group rank
    i (an all-to-all, as gloo has no reduce-scatter) and adds the blocks it
    receives in group-rank order (``_rank_sum``).  Counted as one
    reduce-scatter of the result's bytes.  A CUDA tensor is staged through
    host memory."""
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n} blocks")
    h = _host(t.movedim(dim, 0))
    got = torch.empty_like(h)
    dist.all_to_all_single(got, h, group=group)
    out = _rank_sum(got.chunk(n)).movedim(0, dim).contiguous()
    _note("reduce-scatter", out.numel() * out.element_size())
    return out.to(t.device)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Equal chunks of dim 0 exchanged: chunk i goes to group rank i, and
    the result holds the chunks received in group-rank order (the tiled
    JAX ``all_to_all`` with split and concat axis 0).  A CUDA tensor is
    staged through host memory."""
    h = _host(t)
    out = torch.empty_like(h)
    dist.all_to_all_single(out, h, group=group)
    _note("all-to-all", out.numel() * out.element_size())
    return out.to(t.device)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The group's sum (a new tensor): the parts, all-gathered, added in
    group-rank order (``_rank_sum``), so the sum does not depend on gloo's
    schedule.  Counted as one all-reduce of the result's bytes.  A CUDA
    tensor is staged through host memory."""
    h = _host(t)
    parts = [torch.empty_like(h) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, h, group=group)
    h = _rank_sum(parts)
    _note("all-reduce", h.numel() * h.element_size())
    return h.to(t.device)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Global rank ``src``'s tensor, on every rank of the group.  A CUDA
    tensor is staged through host memory."""
    h = _host(t).clone()
    dist.broadcast(h, src=src, group=group)
    _note("broadcast", h.numel() * h.element_size())
    return h.to(t.device)


def send(t: torch.Tensor, dst: int) -> None:
    """Blocking send to global rank ``dst`` (staged through host memory
    from a CUDA tensor)."""
    h = _host(t)
    dist.send(h, dst)
    _note("send/recv", h.numel() * h.element_size())


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """Blocking receive, from global rank ``src``, of a tensor shaped and
    typed as ``like``, onto ``like``'s device."""
    h = torch.empty(like.shape, dtype=like.dtype)
    dist.recv(h, src)
    return h.to(like.device)


# --- the rank harness -------------------------------------------------------

def _tail(path: Path, nbytes: int = 4000) -> str:
    try:
        return path.read_bytes()[-nbytes:].decode(errors="replace")
    except OSError:
        return ""


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def run_ranks(entry: str, world: int, *, backend: str, device: str,
              timeout: float, args=None) -> list:
    """Run ``entry(rank, world, device, args)`` on ``world`` ranks and
    return each rank's result, in rank order.

    ``entry`` is ``"package.module:function"`` or ``"/path/file.py:
    function"``; ``args`` and the results travel by ``torch.save``.  Each
    rank is ``python -m repro_torch.launch.mesh`` in a session of its own,
    with one thread (``OMP_NUM_THREADS=1`` and ``torch.set_num_threads``),
    meeting the others through a ``file://`` store in a temporary
    directory, where its stdout, stderr and result go.  ``device`` is
    ``"cpu"`` or ``"cuda"`` (every rank on ``cuda:0``); before CUDA ranks
    start, the caller builds every kernel library once.  On the timeout,
    or when a rank exits non-zero, every rank is killed and this raises
    with each rank's stderr tail; no process is left behind."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the ranks run on "
                         f"{BACKENDS} (NCCL refuses two ranks on one card)")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    work = Path(tempfile.mkdtemp(prefix="ranks-"))
    procs = []
    try:
        torch.save(args, work / "args.pt")
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(SRC)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        for r in range(world):
            with open(work / f"stdout{r}.txt", "wb") as out, \
                    open(work / f"stderr{r}.txt", "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.mesh",
                     "--rank", str(r), "--world", str(world),
                     "--dir", str(work), "--entry", entry,
                     "--backend", backend, "--device", device,
                     "--timeout", str(timeout)],
                    stdin=subprocess.DEVNULL, stdout=out, stderr=err,
                    env=env, start_new_session=True))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code {codes[bad[0]]}"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failed = f"timed out after {timeout:g} s"
            else:
                time.sleep(0.02)
        if failed is not None:
            _kill(procs)
            tails = "\n".join(
                f"--- rank {r} (exit {p.returncode}) stderr:\n"
                f"{_tail(work / f'stderr{r}.txt')}"
                for r, p in enumerate(procs))
            raise RuntimeError(f"run_ranks({entry!r}, {world}): {failed}\n"
                               f"{tails}")
        return [torch.load(work / f"result{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        _kill(procs)
        shutil.rmtree(work, ignore_errors=True)


def _load_entry(entry: str):
    where, _, name = entry.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_rank_entry", where)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank of run_ranks")
    for flag in ("--dir", "--entry", "--backend", "--device"):
        p.add_argument(flag, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--timeout", type=float, required=True)
    a = p.parse_args(argv)
    torch.set_num_threads(1)
    work = Path(a.dir)
    device = torch.device(a.device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    dist.init_process_group(
        a.backend, init_method=(work / "store").as_uri(), rank=a.rank,
        world_size=a.world,
        timeout=datetime.timedelta(seconds=a.timeout))
    try:
        fn = _load_entry(a.entry)
        args = torch.load(work / "args.pt", weights_only=False)
        result = fn(a.rank, a.world, device, args)
        tmp = work / f"result{a.rank}.pt.tmp"
        torch.save(result, tmp)
        os.replace(tmp, work / f"result{a.rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main())
