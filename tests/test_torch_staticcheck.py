"""The port's staticcheck twin (``repro_torch.analysis.staticcheck``):
every port rule fires on a known-bad fixture and stays quiet on the paired
known-good one (SC01's roots: a kernel wrapper and a no-host-sync region;
SC03: a kernel directory without ``ref.py``, a library without a source,
an ``ops.py`` that falls back to ``ref`` inside ``except`` or on its CUDA
branch; SC04: the torch forms of the reference's fixtures, two findings
on the bad one, and a direct ``dist.all_reduce`` sum outside
``launch/mesh.py``); the ignore comment and the CLI's exit codes behave as the
reference's; ``src/repro_torch`` scans clean."""
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis.staticcheck import (load_baseline, new_findings,
                                              scan, write_baseline)
from repro_torch.analysis.staticcheck.__main__ import main

ROOT = Path(__file__).resolve().parents[1]


def _write(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def _scan(tmp_path, files):
    _write(tmp_path, files)
    return scan([tmp_path / "src"])


def _count(findings, rule):
    return [f.rule for f in findings].count(rule)


# --- SC01 host-sync ----------------------------------------------------------

SC01_WRAPPER_BAD = """
    import torch
    from pkg.core.helpers import normalize

    def flash_cuda(q: torch.Tensor, k, window: int = 0):
        n = q.numel()
        if torch.any(q > 0):             # branch on a device value
            pass
        scale = float(q.abs().max())     # float() of a tensor
        lens = k.tolist()                # a read per call
        torch.cuda.synchronize()         # stalls the host
        return normalize(q)
"""

SC01_HELPERS_BAD = """
    def normalize(x):
        return x / x.sum().item()        # reached from the wrapper
"""

SC01_WRAPPER_GOOD = """
    import torch

    def flash_cuda(q: torch.Tensor, k, window: int = 0):
        n = q.numel()
        d = int(q.shape[-1])                              # a shape read
        scale = float(torch.tensor(d ** -0.5, dtype=q.dtype))  # host tensor
        w = int(window)                                   # a host int
        if q.is_cuda and torch.is_tensor(k):              # static reads
            out = torch.empty_like(q)
        return out, q.data_ptr(), scale, w
"""

SC01_HOST_ONLY = """
    def report(x):
        return float(x.sum().item())     # host-only code may read
"""

SC01_REGION = """
    import torch
    from repro_torch.common import no_host_sync

    def route(solver, a):
        with no_host_sync():
            out = solver(a)
            if torch.all(out > 0):       # a read inside the region
                pass
            step(out)
        return out

    def step(out):
        return out.cpu()                 # reached from the region
"""


def test_sc01_fires_in_wrappers_and_what_they_reach(tmp_path):
    bad = _scan(tmp_path / "bad", {
        "src/pkg/kernels/flash/kernel.py": SC01_WRAPPER_BAD,
        "src/pkg/core/helpers.py": SC01_HELPERS_BAD,
        "src/pkg/core/report.py": SC01_HOST_ONLY})
    lines = {(f.path.rsplit("/", 1)[-1], f.line) for f in bad
             if f.rule == "SC01"}
    assert lines == {("kernel.py", 7), ("kernel.py", 9), ("kernel.py", 10),
                     ("kernel.py", 11), ("helpers.py", 3)}, lines
    good = _scan(tmp_path / "good", {
        "src/pkg/kernels/flash/kernel.py": SC01_WRAPPER_GOOD,
        "src/pkg/core/report.py": SC01_HOST_ONLY})
    assert _count(good, "SC01") == 0, [f.render() for f in good]


def test_sc01_fires_under_a_no_host_sync_region(tmp_path):
    found = _scan(tmp_path, {"src/pkg/core/route.py": SC01_REGION})
    assert sorted(f.line for f in found if f.rule == "SC01") == [8, 14]


def test_sc01_skips_the_plain_versions(tmp_path):
    """ops.py reaches ref.py only on CPU tensors: no finding there."""
    found = _scan(tmp_path, {
        "src/pkg/kernels/k/ops.py": """
            from .kernel import k_cuda
            from .ref import k_ref

            def k(x):
                if x.is_cuda:
                    return k_cuda(x)
                return k_ref(x)
        """,
        "src/pkg/kernels/k/kernel.py": "def k_cuda(x):\n    return x\n",
        "src/pkg/kernels/k/ref.py": """
            def k_ref(x):
                return x * x.max().item()
        """})
    assert _count(found, "SC01") == 0


# --- SC03 kernel-contract ----------------------------------------------------

OPS_GOOD = """
    from .kernel import k_cuda
    from .ref import k_ref

    def k(x):
        if x.is_cuda:
            return k_cuda(x)
        if x.device.type != "cpu":
            raise ValueError(x.device)
        return k_ref(x)
"""

OPS_EXCEPT_FALLBACK = """
    from .kernel import k_cuda
    from .ref import k_ref

    def k(x):
        try:
            return k_cuda(x)
        except RuntimeError:
            return k_ref(x)                # falls back inside except
"""

OPS_CUDA_BRANCH_TO_REF = """
    from . import ref
    from .kernel import k_cuda
    from .ref import k_ref

    def k(x, big=False):
        if x.is_cuda:
            if big:
                return k_ref(x)            # the CUDA branch reaches ref
            return k_cuda(x)
        return k_ref(x)
"""

KERNEL_PY = """
    from .. import _build

    def k_cuda(x):
        return _build.load("k").k_launch(x)
"""


def _kernel_tree(ops, *, ref=True, source=True, test=True):
    files = {"src/pkg/kernels/k/ops.py": ops,
             "src/pkg/kernels/k/kernel.py": KERNEL_PY}
    if ref:
        files["src/pkg/kernels/k/ref.py"] = "def k_ref(x):\n    return x\n"
    if source:
        files["src/pkg/csrc/k.cu"] = "// k_launch\n"
    files["tests/test_torch_k.py"] = ("from pkg.kernels.k import ops\n" if test
                                      else "def test_nothing():\n    pass\n")
    return files


def test_sc03_quiet_on_a_complete_kernel_dir(tmp_path):
    found = _scan(tmp_path, _kernel_tree(OPS_GOOD))
    assert _count(found, "SC03") == 0, [f.render() for f in found]


@pytest.mark.parametrize("case,want", [
    ("no ref.py", "missing ref.py"),
    ("no source", "no source csrc/k.cu"),
    ("no test", "no tests/test_torch_*.py"),
    ("except fallback", "a `try` around a kernel launch"),
    ("cuda branch to ref", "the CUDA branch of ops.py reaches"),
])
def test_sc03_fires_on_a_broken_contract(tmp_path, case, want):
    files = {
        "no ref.py": _kernel_tree(OPS_GOOD, ref=False),
        "no source": _kernel_tree(OPS_GOOD, source=False),
        "no test": _kernel_tree(OPS_GOOD, test=False),
        "except fallback": _kernel_tree(OPS_EXCEPT_FALLBACK),
        "cuda branch to ref": _kernel_tree(OPS_CUDA_BRANCH_TO_REF),
    }[case]
    found = [f for f in _scan(tmp_path, files) if f.rule == "SC03"]
    assert len(found) == 1 and want in found[0].message, \
        [f.render() for f in found]


# --- SC04 unsafe-reduction ---------------------------------------------------
# the torch forms of the reference's SC04_BAD and SC04_GOOD
# (tests/test_staticcheck.py)

SC04_BAD = """
    import torch

    def solve(cost, *, group=None):
        lblocks = 4
        c3 = cost.reshape(lblocks, -1)
        total = torch.sum(c3)    # the order of the ranks' parts is unfixed
        frac = c3.mean()
        return total + frac
"""

SC04_GOOD = """
    import torch
    from pkg.launch.mesh import _rank_sum, all_gather

    def solve(cost, loads, *, group=None):
        lblocks = 4
        c3 = cost.reshape(lblocks, -1)
        parts = all_gather(c3, group)        # every rank's blocks
        total = _rank_sum(list(parts)).sum() # added in rank order first
        cap = torch.mean(loads)   # replicated (M,) input: untainted, fine
        return total / cap
"""

SC04_DIST_BAD = """
    import torch
    import torch.distributed as dist

    def reduce(x, group):
        dist.all_reduce(x, group=group)      # the backend picks the order
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)   # exact
        return x
"""


def test_sc04_fires_on_bad_and_not_on_good(tmp_path):
    bad = _scan(tmp_path / "bad", {"src/pkg/mod.py": SC04_BAD})
    assert sorted(f.line for f in bad if f.rule == "SC04") == [7, 8], \
        [f.render() for f in bad]
    good = _scan(tmp_path / "good", {"src/pkg/mod.py": SC04_GOOD})
    assert _count(good, "SC04") == 0, [f.render() for f in good]


def test_sc04_refuses_a_direct_dist_sum_outside_the_mesh(tmp_path):
    found = _scan(tmp_path / "a", {"src/pkg/core/mod.py": SC04_DIST_BAD})
    assert [f.line for f in found if f.rule == "SC04"] == [6], \
        [f.render() for f in found]
    # launch/mesh.py is the one place that talks to torch.distributed
    mesh = _scan(tmp_path / "b", {"src/pkg/launch/mesh.py": SC04_DIST_BAD})
    assert _count(mesh, "SC04") == 0


# --- SC06, SC07, SC09, SC10 ---------------------------------------------------

SC06_BAD = """
    def steal_a_page(server):
        ep = server.endpoints[0]
        ep.alloc.free_pages.pop()
        ep.alloc._free_page_set.clear()
        ep.block_table[0, 0] = 7
        ep._slot_pages[0].append(7)
        del ep.alloc.free_slots[0]
"""

SC06_GOOD = """
    class PageAllocator:
        def release_pages(self, pages):
            self.free_pages.extend(pages)
            self._free_page_set.update(pages)

    class Endpoint:
        def _free_slot(self, slot):
            self.block_table[slot] = 0
            self._slot_pages[slot] = []

    def read_only(server):
        return len(server.endpoints[0].alloc.free_pages)
"""

SC07_BAD = """
    def reset_budget(state):
        return state._replace(budget_spent=0.0)

    def forge(lam):
        return DualState(lam, lam, 0.0, 0.0, 0.0)
"""

SC07_GOOD = """
    class StreamController:
        def fold(self, state, csum):
            return state._replace(budget_spent=state.budget_spent + csum)

    def read_ledger(state):
        return float(state.budget_spent)
"""

SC09_BAD = """
    def force_close(health):
        health.breaker_state[0] = 0
        health.fail_ewma[:] = 0.0
        health.trips += 1
        health.probe_wins.fill(5)
        del health.open_until
"""

SC09_GOOD = """
    class HealthTracker:
        def record(self, j, ok):
            self.breaker_state[j] = 1

    def read_only(health, loads):
        return health.effective_loads(loads), health.breaker_state == 1
"""

SC10_BAD = """
    import torch

    def spec_accept_loop(ep, tokens, strong, pages):
        emitted = []
        for j in range(4):
            if torch.all(tokens[j] == strong[j]):
                emitted.append(int(torch.argmax(strong[j])))
        ep.alloc.release_pages(pages)
        return emitted
"""

SC10_GOOD = """
    import torch

    def _verify_accept(tokens, strong, remaining):
        matches = (tokens[:, 1:] == strong[:, :-1]).int()
        prefix = torch.cumprod(matches, dim=1).sum(dim=1)
        return torch.minimum(prefix + 1, remaining)

    def spec_accept_loop(ep, seqs, n_emit):
        n_emit = n_emit.tolist()                     # ONE read a round
        for s in seqs:
            s.base += int(n_emit[s.slot])
            ep.rollback_pages(s.slot, s.base)
"""


@pytest.mark.parametrize("rule,bad,good,n", [
    ("SC06", SC06_BAD, SC06_GOOD, 5), ("SC07", SC07_BAD, SC07_GOOD, 2),
    ("SC09", SC09_BAD, SC09_GOOD, 5), ("SC10", SC10_BAD, SC10_GOOD, 3)])
def test_discipline_rules_fire_on_bad_and_not_on_good(tmp_path, rule, bad,
                                                      good, n):
    found = _scan(tmp_path / "bad", {"src/pkg/mod.py": bad})
    assert _count(found, rule) == n, [f.render() for f in found]
    assert _count(_scan(tmp_path / "good", {"src/pkg/mod.py": good}),
                  rule) == 0


# --- ignore comments, baseline, CLI, the port's tree --------------------------

def test_ignore_comment_with_a_reason(tmp_path):
    found = _scan(tmp_path, {"src/pkg/kernels/k/kernel.py": """
        def k_cuda(x):
            a = x.item()  # staticcheck: ignore[SC01] -- a deliberate read
            # staticcheck: ignore[SC01] -- the line below, too
            b = x.tolist()
            return a, b, x.cpu()
    """})
    assert [f.line for f in found if f.rule == "SC01"] == [6]


def test_cli_exit_codes(tmp_path, monkeypatch):
    _write(tmp_path, {"src/pkg/good.py": SC09_GOOD,
                      "src/pkg/bad.py": SC09_BAD})
    monkeypatch.chdir(tmp_path)
    assert main([str(tmp_path / "src/pkg/good.py")]) == 0
    assert main([str(tmp_path / "src/pkg/bad.py")]) == 1
    assert main([str(tmp_path / "src"), "--write-baseline"]) == 0
    assert main([str(tmp_path / "src")]) == 0  # grandfathered now
    bl = load_baseline(tmp_path / "staticcheck-torch-baseline.txt")
    assert bl == {("src/pkg/bad.py", "SC09"): 5}
    write_baseline([], tmp_path / "empty.txt")
    assert main([str(tmp_path / "src"), "--baseline",
                 str(tmp_path / "empty.txt")]) == 1


def test_port_tree_is_clean():
    findings = scan([ROOT / "src" / "repro_torch"])
    assert new_findings(findings, {}) == [], \
        "\n".join(f.render() for f in findings)
    assert main([str(ROOT / "src" / "repro_torch"), "--baseline",
                 str(ROOT / "no-such-baseline.txt")]) == 0
