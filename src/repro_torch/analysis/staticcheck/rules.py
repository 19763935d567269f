"""Rule implementations of the port: SC01, SC03, SC04, SC06, SC07, SC09,
SC10.

Each returns a list of Findings; messages are fixer-facing: they say what
to change, not just what matched.  SC06, SC07 and SC09 are the
reference's rules (``repro.analysis.staticcheck.rules``) unchanged; SC01,
SC03, SC04 and SC10 are their PyTorch forms.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .callgraph import CallGraph
from .core import Finding, Module

SCALAR_CASTS = {"float", "int", "bool"}
# reads that never touch a tensor's data
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_meta",
                "is_sparse", "layout", "itemsize", "nbytes", "requires_grad",
                "names"}
STATIC_METHODS = {"dim", "size", "numel", "element_size", "data_ptr",
                  "stride", "is_contiguous", "storage_offset", "get_device",
                  "nelement", "is_floating_point", "ndimension",
                  "untyped_storage"}
# methods only a tensor has: a name they are read from holds a tensor
TENSOR_ONLY = {"data_ptr", "is_cuda", "contiguous", "element_size", "numel",
               "cuda", "is_contiguous", "untyped_storage", "storage_offset"}
# host values: calls that return a Python value, not a tensor
HOST_METHODS = {"item", "tolist"}
# torch.* functions that return no device value
STATIC_TORCH = {"is_tensor", "is_floating_point", "is_complex",
                "is_grad_enabled", "is_inference_mode_enabled",
                "get_default_dtype", "device", "dtype", "finfo", "iinfo",
                "Size", "Generator", "no_grad", "inference_mode",
                "enable_grad", "set_grad_enabled", "promote_types",
                "result_type", "can_cast", "numel", "typename",
                "are_deterministic_algorithms_enabled", "is_storage"}
# torch.* builders that make a host tensor unless given a device
HOST_BUILDERS = {"tensor", "as_tensor", "from_numpy"}
SYNC_METHODS = {"item": "`.item()`", "tolist": "`.tolist()`",
                "cpu": "`.cpu()`"}


def _func_params(node: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    a = node.args
    names = [p.arg for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return {n for n in names if n not in ("self", "cls")}


def _is_torch_attr(func: ast.expr) -> bool:
    return (isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name) and func.value.id == "torch")


class _Tensors:
    """Which expressions of one function hold a tensor: a tensor-valued
    ``torch.*`` call (a host builder without ``device=`` excepted), a
    parameter annotated ``Tensor``, a name a tensor-only method is read
    from, a name bound to a tensor value, and what indexing, arithmetic and
    tensor methods make of those."""

    def __init__(self, fnode: ast.AST | None, modules: set[str] = frozenset()):
        self.names: set[str] = set()
        if fnode is None:
            return
        if isinstance(fnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = fnode.args
            for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
                ann = p.annotation
                if ann is not None and "Tensor" in ast.unparse(ann):
                    self.names.add(p.arg)
        for n in ast.walk(fnode):
            if (isinstance(n, ast.Attribute) and n.attr in TENSOR_ONLY
                    and isinstance(n.value, ast.Name)
                    and n.value.id not in modules):
                self.names.add(n.value.id)
        for _ in range(2):   # bindings in any order, two passes
            for n in ast.walk(fnode):
                if (isinstance(n, ast.Assign) and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name)
                        and self.holds(n.value)):
                    self.names.add(n.targets[0].id)

    def holds(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Call):
            f = e.func
            if _is_torch_attr(f):
                if f.attr in STATIC_TORCH:
                    return False
                if f.attr in HOST_BUILDERS:
                    return any(kw.arg == "device" for kw in e.keywords)
                return True
            if isinstance(f, ast.Attribute):
                if f.attr in STATIC_METHODS or f.attr in HOST_METHODS:
                    return False
                return self.holds(f.value)
            return False
        if isinstance(e, ast.Attribute):
            return e.attr not in STATIC_ATTRS and self.holds(e.value)
        if isinstance(e, ast.Subscript):
            return self.holds(e.value)
        if isinstance(e, ast.BinOp):
            return self.holds(e.left) or self.holds(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.holds(e.operand)
        if isinstance(e, ast.Compare):
            return self.holds(e.left) or any(self.holds(c)
                                             for c in e.comparators)
        if isinstance(e, ast.BoolOp):
            return any(self.holds(v) for v in e.values)
        return False


def _tensor_call_in(expr: ast.expr, tensors: _Tensors) -> str | None:
    """First tensor-valued call inside ``expr``, rendered, if any."""
    for c in ast.walk(expr):
        if isinstance(c, ast.Call) and tensors.holds(c):
            return ast.unparse(c.func)
    return None


# ---------------------------------------------------------------------------
# SC01 host-sync
# ---------------------------------------------------------------------------

def _sync_findings(mod: Module, body: ast.AST, tensors: _Tensors,
                   where: str) -> list[Finding]:
    findings: list[Finding] = []

    def flag(node: ast.AST, msg: str) -> None:
        findings.append(Finding(mod.rel, node.lineno, "SC01", msg))

    for n in ast.walk(body):
        if isinstance(n, ast.Call):
            f = n.func
            if (isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS
                    and not n.args):
                flag(n, f"{SYNC_METHODS[f.attr]} {where} waits for the "
                     "device; keep the value on the card, or read the batch "
                     "once outside the hot path (common.device_get).")
            elif (isinstance(f, ast.Attribute) and f.attr == "synchronize"
                    and ast.unparse(f.value) == "torch.cuda"):
                flag(n, f"`torch.cuda.synchronize()` {where} stalls the host "
                     "until the card drains; let the stream order the work.")
            elif (isinstance(f, ast.Name) and f.id in SCALAR_CASTS
                    and n.args and tensors.holds(n.args[0])):
                flag(n, f"`{f.id}()` of a tensor {where} copies it to the "
                     "host and waits; keep the math on the card or pass a "
                     "host value in.")
        test = n.test if isinstance(n, (ast.If, ast.While, ast.IfExp)) \
            else None
        if test is not None:
            hit = _tensor_call_in(test, tensors)
            if hit is not None:
                flag(n, f"Python branch on tensor-valued `{hit}(...)` {where}"
                     " reads the device; use torch.where / a masked update, "
                     "or hoist the check out of the hot path.")
    return findings


def _imported_names(tree: ast.Module) -> set[str]:
    """Names the module's imports bind (``torch``, ``np``, ``F`` ...)."""
    return {a.asname or a.name.split(".")[0]
            for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in n.names}


def _check_sc01(mod: Module, graph: CallGraph) -> list[Finding]:
    findings: list[Finding] = []
    modules = _imported_names(mod.tree)
    for fnode in ast.walk(mod.tree):
        if (isinstance(fnode, (ast.FunctionDef, ast.AsyncFunctionDef))
                and graph.is_reachable(fnode)):
            findings += _sync_findings(
                mod, fnode, _Tensors(fnode, modules),
                f"in `{fnode.name}`, which a kernel wrapper or a "
                "no-host-sync region reaches,")
    for rel, node in graph.regions:
        if rel != mod.rel:
            continue
        scope = next((f for f in ast.walk(mod.tree)
                      if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                      and any(c is node for c in ast.walk(f))), None)
        tensors = _Tensors(scope, modules)
        for stmt in node.body:
            findings += _sync_findings(
                mod, stmt, tensors,
                "inside a no-host-sync or CUDA-graph capture region")
    return findings


# ---------------------------------------------------------------------------
# SC03 kernel-contract (tree-level)
# ---------------------------------------------------------------------------

KERNEL_DIR_RE = re.compile(r"(^|/)kernels/([^/]+)/[^/]+\.py$")


def _load_names(tree: ast.Module) -> list[tuple[int, str]]:
    """(line, library) of every ``load("name")`` call with a literal name."""
    out = []
    for n in ast.walk(tree):
        if (isinstance(n, ast.Call) and n.args
                and isinstance(n.args[0], ast.Constant)
                and isinstance(n.args[0].value, str)):
            f = n.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            if name == "load":
                out.append((n.lineno, n.args[0].value))
    return out


def _imported_from(tree: ast.Module, module: str) -> set[str]:
    """Names a module binds from its sibling ``module`` (``from .module
    import a, b``), and the module itself (``from . import module``)."""
    out: set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.level:
            if n.module == module:
                out |= {a.asname or a.name for a in n.names}
            elif n.module is None:
                out |= {a.asname or a.name for a in n.names
                        if a.name == module}
    return out


def _mentions(node: ast.AST, names: set[str]) -> ast.AST | None:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in names:
            return n
    return None


def _ops_fallbacks(mod: Module) -> list[Finding]:
    """``try`` around a launch, or a CUDA branch that reaches ``ref``."""
    findings: list[Finding] = []
    launches = _imported_from(mod.tree, "kernel")
    plains = _imported_from(mod.tree, "ref")
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Try):
            body = ast.Module(body=n.body, type_ignores=[])
            handlers = ast.Module(body=[s for h in n.handlers for s in h.body],
                                  type_ignores=[])
            if _mentions(body, launches) is not None or \
                    _mentions(handlers, plains) is not None:
                findings.append(Finding(
                    mod.rel, n.lineno, "SC03",
                    "a `try` around a kernel launch in ops.py is a fallback: "
                    "a CUDA tensor launches the kernel or raises; let the "
                    "launch's error reach the caller."))
        if isinstance(n, ast.If) and "cuda" in ast.unparse(n.test):
            branch = ast.Module(body=n.body, type_ignores=[])
            hit = _mentions(branch, plains)
            if hit is not None:
                findings.append(Finding(
                    mod.rel, hit.lineno, "SC03",
                    f"the CUDA branch of ops.py reaches the plain version "
                    f"`{hit.id}`: a CUDA tensor launches the kernel or "
                    "raises, the plain version serves CPU tensors only."))
    return findings


def check_kernel_contract(modules: list[Module], repo_root: Path) -> list[Finding]:
    findings: list[Finding] = []
    kernel_dirs: dict[str, Path] = {}
    for m in modules:
        match = KERNEL_DIR_RE.search(m.rel)
        if match:
            kernel_dirs.setdefault(match.group(2), m.path.parent)
            if m.path.name == "ops.py":
                findings += _ops_fallbacks(m)
            if m.path.name == "kernel.py":
                csrc = m.path.parent.parent.parent / "csrc"
                for line, lib in _load_names(m.tree):
                    if not any((csrc / f"{lib}{ext}").exists()
                               for ext in (".cu", ".cpp")):
                        findings.append(Finding(
                            m.rel, line, "SC03",
                            f"kernel.py loads the library `{lib}`, which has "
                            f"no source csrc/{lib}.cu: every library is built "
                            "from the checkout."))

    tests_dir = repo_root / "tests"
    test_blob = ""
    if tests_dir.is_dir():
        test_blob = "\n".join(
            p.read_text() for p in sorted(tests_dir.rglob("test_torch_*.py"))
        )

    for name, kdir in sorted(kernel_dirs.items()):
        rel_dir = kdir.relative_to(repo_root).as_posix() if kdir.is_relative_to(
            repo_root
        ) else kdir.as_posix()
        for required, why in [
            ("kernel.py", "the hand kernel's wrapper"),
            ("ref.py", "the plain version the kernel is held to"),
            ("ops.py", "the entry point that dispatches by device"),
        ]:
            if not (kdir / required).exists():
                findings.append(
                    Finding(
                        f"{rel_dir}/{required}",
                        1,
                        "SC03",
                        f"kernels/{name}/ is missing {required} ({why}); every "
                        "kernel ships the kernel + ref + ops triplet.",
                    )
                )
        if tests_dir.is_dir() and not re.search(
            rf"kernels[./]{re.escape(name)}|kernels\s+import\s+{re.escape(name)}",
            test_blob,
        ):
            findings.append(
                Finding(
                    f"{rel_dir}/kernel.py",
                    1,
                    "SC03",
                    f"no tests/test_torch_*.py references kernels.{name}: add "
                    "a parity test of its plain version against the "
                    "reference.",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# SC06 allocator-discipline / SC07 ledger-discipline
# ---------------------------------------------------------------------------
# The runtime sanitizers (repro.analysis.sanitize) prove these invariants
# dynamically; SC06/SC07 refuse the code shapes that would break them:
# state that only stays consistent because exactly one owner mutates it.

ALLOC_ATTRS = {"free_pages", "free_slots", "block_table", "_slot_pages",
               "_free_page_set"}
ALLOC_OWNERS = {"PageAllocator", "Endpoint"}
MUTATOR_METHODS = {"append", "pop", "extend", "insert", "remove", "clear",
                   "add", "discard", "update", "difference_update",
                   "symmetric_difference_update", "intersection_update",
                   "fill", "sort", "reverse"}

LEDGER_FIELDS = {"lam", "lam_load", "budget_spent", "sr_deficit", "steps"}
LEDGER_OWNERS = {"DualSolver", "StreamController"}


class _ClassStackVisitor(ast.NodeVisitor):
    """Shared base: tracks the enclosing-class stack while walking."""

    def __init__(self, owners: set[str]):
        self._stack: list[str] = []
        self._owners = owners

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def _inside_owner(self) -> bool:
        return any(c in self._owners for c in self._stack)


def _unwrap_subscripts(node: ast.expr) -> ast.expr:
    while isinstance(node, ast.Subscript):
        node = node.value
    return node


def _check_sc06(mod: Module) -> list[Finding]:
    findings: list[Finding] = []

    def _msg(attr: str) -> str:
        return (f"mutation of allocator state `{attr}` outside "
                "PageAllocator/Endpoint methods: the free lists, the O(1) "
                "membership mirror, and PageSan's shadow only stay "
                "consistent when every mutation goes through the allocator "
                "API (alloc_pages/release_pages/alloc_slot/release_slot).")

    class V(_ClassStackVisitor):
        def _flag_target(self, target: ast.expr, lineno: int) -> None:
            t = _unwrap_subscripts(target)
            if isinstance(t, ast.Attribute) and t.attr in ALLOC_ATTRS:
                findings.append(Finding(mod.rel, lineno, "SC06",
                                        _msg(t.attr)))

        def visit_Assign(self, node: ast.Assign) -> None:
            if not self._inside_owner():
                for t in node.targets:
                    self._flag_target(t, node.lineno)
            self.generic_visit(node)

        def visit_AugAssign(self, node: ast.AugAssign) -> None:
            if not self._inside_owner():
                self._flag_target(node.target, node.lineno)
            self.generic_visit(node)

        def visit_Delete(self, node: ast.Delete) -> None:
            if not self._inside_owner():
                for t in node.targets:
                    self._flag_target(t, node.lineno)
            self.generic_visit(node)

        def visit_Call(self, node: ast.Call) -> None:
            f = node.func
            if (not self._inside_owner() and isinstance(f, ast.Attribute)
                    and f.attr in MUTATOR_METHODS):
                v = _unwrap_subscripts(f.value)
                if isinstance(v, ast.Attribute) and v.attr in ALLOC_ATTRS:
                    findings.append(Finding(mod.rel, node.lineno, "SC06",
                                            _msg(v.attr)))
            self.generic_visit(node)

    V(ALLOC_OWNERS).visit(mod.tree)
    return findings


def _check_sc07(mod: Module) -> list[Finding]:
    # the module that DEFINES DualState owns its constructors (the NamedTuple
    # declaration, init_dual_state, and the solver's own ledger update)
    if any(isinstance(n, ast.ClassDef) and n.name == "DualState"
           for n in ast.walk(mod.tree)):
        return []
    findings: list[Finding] = []
    msg = ("write to DualState ledger fields outside DualSolver/"
           "StreamController: budget_spent/sr_deficit/steps are a conserved "
           "running ledger — constructing or `_replace`-ing them elsewhere "
           "breaks conservation (LedgerSan catches the same at runtime).")

    class V(_ClassStackVisitor):
        def visit_Call(self, node: ast.Call) -> None:
            f = node.func
            if not self._inside_owner():
                if isinstance(f, ast.Name) and f.id == "DualState":
                    findings.append(Finding(mod.rel, node.lineno, "SC07", msg))
                elif (isinstance(f, ast.Attribute) and f.attr == "_replace"
                        and {kw.arg for kw in node.keywords} & LEDGER_FIELDS):
                    findings.append(Finding(mod.rel, node.lineno, "SC07", msg))
            self.generic_visit(node)

    V(LEDGER_OWNERS).visit(mod.tree)
    return findings


# ---------------------------------------------------------------------------
# SC09 health-state discipline
# ---------------------------------------------------------------------------

HEALTH_ATTRS = {"breaker_state", "fail_ewma", "lat_ewma", "open_until",
                "probe_inflight", "probe_wins", "events_seen", "trips"}
HEALTH_OWNERS = {"HealthTracker"}


def _check_sc09(mod: Module) -> list[Finding]:
    """Breaker/EWMA state may only be mutated inside ``HealthTracker``: the
    executors report outcomes through ``record``/``note_admit`` and the
    routing side reads pure views (``effective_loads``/``admissible``).  A
    write from anywhere else desynchronizes the breaker state machine from
    its hysteresis counters (and the racecheck breaker invariant with it)."""
    findings: list[Finding] = []

    def _msg(attr: str) -> str:
        return (f"mutation of health state `{attr}` outside HealthTracker: "
                "breaker transitions and the failure/latency EWMAs only stay "
                "consistent when every update goes through the tracker API "
                "(record/note_admit/advance).")

    class V(_ClassStackVisitor):
        def _flag_target(self, target: ast.expr, lineno: int) -> None:
            t = _unwrap_subscripts(target)
            if isinstance(t, ast.Attribute) and t.attr in HEALTH_ATTRS:
                findings.append(Finding(mod.rel, lineno, "SC09",
                                        _msg(t.attr)))

        def visit_Assign(self, node: ast.Assign) -> None:
            if not self._inside_owner():
                for t in node.targets:
                    self._flag_target(t, node.lineno)
            self.generic_visit(node)

        def visit_AugAssign(self, node: ast.AugAssign) -> None:
            if not self._inside_owner():
                self._flag_target(node.target, node.lineno)
            self.generic_visit(node)

        def visit_Delete(self, node: ast.Delete) -> None:
            if not self._inside_owner():
                for t in node.targets:
                    self._flag_target(t, node.lineno)
            self.generic_visit(node)

        def visit_Call(self, node: ast.Call) -> None:
            f = node.func
            if (not self._inside_owner() and isinstance(f, ast.Attribute)
                    and f.attr in MUTATOR_METHODS):
                v = _unwrap_subscripts(f.value)
                if isinstance(v, ast.Attribute) and v.attr in HEALTH_ATTRS:
                    findings.append(Finding(mod.rel, node.lineno, "SC09",
                                            _msg(v.attr)))
            self.generic_visit(node)

    V(HEALTH_OWNERS).visit(mod.tree)
    return findings


# ---------------------------------------------------------------------------
# SC10 speculative-contract
# ---------------------------------------------------------------------------
# The speculative cascade's acceptance loop is correctness-critical host
# code sitting right next to device results: the cheap-looking shapes are a
# per-token host sync (int()/bool() on a device value, or a Python branch
# on one) and page rollback that bypasses the allocator's owners.  SC10
# refuses both inside speculative/acceptance code.

SPEC_NAME_RE = re.compile(
    r"(^|_)(spec\w*|speculat\w*|accept\w*|draft\w*|verify\w*)", re.I)
DEVICE_SYNC_CASTS = {"int", "bool", "float"}
ALLOC_METHODS = {"alloc_pages", "release_pages", "alloc_slot", "release_slot"}


def _check_sc10(mod: Module) -> list[Finding]:
    findings: list[Finding] = []
    bare = _Tensors(None)   # tensor-valued torch.* calls only

    class V(_ClassStackVisitor):
        def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
            self._visit_func(node)

        def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
            self._visit_func(node)

        def _visit_func(self, fnode) -> None:
            if not SPEC_NAME_RE.search(fnode.name):
                self.generic_visit(fnode)
                return
            for n in ast.walk(fnode):
                test = (n.test
                        if isinstance(n, (ast.If, ast.While, ast.IfExp))
                        else None)
                if test is not None:
                    hit = _tensor_call_in(test, bare)
                    if hit is not None:
                        findings.append(Finding(
                            mod.rel, n.lineno, "SC10",
                            f"Python branch on device value `{hit}(...)` in "
                            f"speculative/acceptance code `{fnode.name}`: "
                            "acceptance decisions must stay on the device "
                            "(torch.where / cumprod prefix) with ONE batched "
                            "host read per round."))
                if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                        and n.func.id in DEVICE_SYNC_CASTS and n.args):
                    hit = _tensor_call_in(n.args[0], bare)
                    if hit is not None:
                        findings.append(Finding(
                            mod.rel, n.lineno, "SC10",
                            f"`{n.func.id}()` on device value `{hit}(...)` "
                            f"in speculative/acceptance code `{fnode.name}` "
                            "syncs the host per value; compute acceptance on "
                            "the device and fetch the round's results with "
                            "one batched read."))
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr in ALLOC_METHODS
                        and not self._inside_owner()):
                    recv = _unwrap_subscripts(n.func.value)
                    if isinstance(recv, ast.Attribute) and recv.attr == "alloc":
                        findings.append(Finding(
                            mod.rel, n.lineno, "SC10",
                            f"draft KV pages {n.func.attr.split('_')[0]}'d by "
                            "reaching through `.alloc` outside PageAllocator/"
                            "Endpoint: route speculative page churn through "
                            "Endpoint methods (ensure_pages / rollback_pages "
                            "/ release_spec) so the block table and PageSan's "
                            "shadow stay consistent."))
            self.generic_visit(fnode)

    V(ALLOC_OWNERS).visit(mod.tree)
    return findings


# ---------------------------------------------------------------------------
# SC04 unsafe-reduction
# ---------------------------------------------------------------------------
# A float sum across ranks must go through the port's one ordered place
# (ROADMAP C4): ``launch.mesh._rank_sum``, which the counted ``all_reduce``
# and ``reduce_scatter`` wrappers use, and ``kernels.lagrangian_assign.ref.
# ordered_sum``.  In a sharded scope (a function that takes a group or a
# mesh, reads a ``mesh`` attribute, or asks for its rank, its index on an
# axis or a mesh's group), the parts an all-gather
# returns and values reshaped into a (blocks, ...) layout are tainted; a
# ``.sum()``/``.mean()``/``torch.sum``/``torch.mean`` over them outside
# those helpers adds the ranks' parts in an order nobody fixed.  A direct
# ``torch.distributed`` sum (``all_reduce`` or ``reduce_scatter_tensor``
# with ``ReduceOp.SUM``, the default) leaves the order to the backend and
# is refused anywhere but ``launch/mesh.py``.

SC04_REDUCTIONS = {"sum", "mean"}
SC04_ORDERED = {"_rank_sum", "ordered_sum", "all_reduce", "reduce_scatter"}
SC04_GATHERS = {"all_gather", "gather_dim"}
SC04_DIST_SUMS = {"all_reduce", "reduce_scatter_tensor", "reduce_scatter"}
BLOCK_DIM_RE = re.compile(r"(^|_)(l|n)?blocks?$|(^|_)shards?$")
SC04_SCOPE_PARAMS = re.compile(r"(^|_)(group|mesh)$")


def _name_of(func: ast.expr) -> str | None:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _root(node: ast.expr) -> str | None:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _dist_names(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(names bound to ``torch.distributed``, names imported from it)."""
    modules, members = set(), set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.name == "torch.distributed" and a.asname:
                    modules.add(a.asname)
        elif isinstance(n, ast.ImportFrom):
            if n.module == "torch" and n.names:
                modules |= {a.asname or a.name for a in n.names
                            if a.name == "distributed"}
            elif n.module == "torch.distributed":
                members |= {a.asname or a.name for a in n.names}
    return modules, members


def _is_dist_call(call: ast.Call, modules: set[str], members: set[str]
                  ) -> str | None:
    """The ``torch.distributed`` function a call names, or None."""
    f = call.func
    if isinstance(f, ast.Name) and f.id in members:
        return f.id
    if isinstance(f, ast.Attribute):
        v = f.value
        if isinstance(v, ast.Name) and v.id in modules:
            return f.attr
        if (isinstance(v, ast.Attribute) and v.attr == "distributed"
                and isinstance(v.value, ast.Name) and v.value.id == "torch"):
            return f.attr
    return None


def _is_sum_op(call: ast.Call) -> bool:
    """No ``op`` (SUM is the default), or an op naming SUM."""
    ops = [k.value for k in call.keywords if k.arg == "op"]
    if not ops:
        return True
    return any(isinstance(o, ast.Attribute) and o.attr == "SUM" for o in ops)


def _sc04_scope(fnode, modules: set[str], members: set[str]) -> bool:
    if any(SC04_SCOPE_PARAMS.search(p) for p in _func_params(fnode)):
        return True
    for n in ast.walk(fnode):
        if isinstance(n, ast.Call) and (
                _is_dist_call(n, modules, members) == "get_rank"
                or _name_of(n.func) in ("group", "get_rank")):
            return True
        if isinstance(n, ast.Call) and _name_of(n.func) == "axis_index":
            return True
        if isinstance(n, ast.Attribute) and n.attr in ("rank", "mesh") \
                and isinstance(n.ctx, ast.Load):
            return True
    return False


def _check_sc04(mod: Module) -> list[Finding]:
    findings: list[Finding] = []
    modules, members = _dist_names(mod.tree)
    if not mod.rel.endswith("launch/mesh.py"):
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Call):
                continue
            name = _is_dist_call(n, modules, members)
            if name in SC04_DIST_SUMS and _is_sum_op(n):
                findings.append(Finding(
                    mod.rel, n.lineno, "SC04",
                    f"direct `torch.distributed.{name}` with SUM: the "
                    "backend picks the order of the ranks' parts, so the sum "
                    "differs from run to run and from the one-rank result; "
                    "use `launch.mesh.all_reduce` / `reduce_scatter`, which "
                    "add them in group-rank order (`_rank_sum`)."))
    scopes: list[ast.AST] = []

    def find(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _sc04_scope(child, modules, members):
                scopes.append(child)     # nested defs analysed within it
            else:
                find(child)

    find(mod.tree)
    for scope in scopes:
        findings.extend(_check_sc04_scope(mod, scope, modules, members))
    return findings


def _check_sc04_scope(mod: Module, scope, modules: set[str],
                      members: set[str]) -> list[Finding]:
    def gathered(node: ast.AST) -> bool:
        """A gather that returns the ranks' parts (the port's wrappers;
        ``dist.all_gather`` writes them into its first argument)."""
        return (isinstance(node, ast.Call)
                and _name_of(node.func) in SC04_GATHERS
                and _is_dist_call(node, modules, members) is None)

    tainted: set[str] = {"<gather>"}
    for n in ast.walk(scope):
        if not isinstance(n, ast.Call):
            continue
        if (_is_dist_call(n, modules, members) == "all_gather" and n.args
                and isinstance(n.args[0], ast.Name)):
            tainted.add(n.args[0].id)
        if (_name_of(n.func) == "reshape" and isinstance(n.func, ast.Attribute)
                and n.args and isinstance(n.args[0], ast.Name)
                and BLOCK_DIM_RE.search(n.args[0].id)):
            root = _root(n.func.value)
            if root:
                tainted.add(root)

    def names_outside(node: ast.AST) -> set[str]:
        """The names ``node`` reads, and "<gather>" for a gather's parts;
        the ordered helpers' results are clean, and shape reads and len()
        are static, not data flow."""
        if isinstance(node, ast.Call) and _name_of(node.func) in SC04_ORDERED:
            return set()
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            return set()
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "len":
            return set()
        out = {node.id} if isinstance(node, ast.Name) else set()
        if gathered(node):
            out.add("<gather>")
        for child in ast.iter_child_nodes(node):
            out |= names_outside(child)
        return out

    changed = True
    while changed:
        changed = False
        for n in ast.walk(scope):
            if not isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                continue
            if n.value is None:
                continue
            if not names_outside(n.value) & tainted:
                continue
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                for c in ast.walk(t):
                    if isinstance(c, ast.Name) and c.id not in tainted:
                        tainted.add(c.id)
                        changed = True
    findings: list[Finding] = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in SC04_ORDERED and node is not scope:
            return                          # the ordered helpers themselves
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in SC04_REDUCTIONS):
            torch_fn = (isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "torch")
            operands = list(node.args) if torch_fn else [node.func.value]
            names = set()
            for op in operands:
                names |= names_outside(op)
            hit = sorted(names & tainted)
            if hit:
                what = (f"torch.{node.func.attr}" if torch_fn
                        else f".{node.func.attr}()")
                part = ("an all-gather's result" if hit[-1] == "<gather>"
                        else f"`{hit[-1]}`")
                findings.append(Finding(
                    mod.rel, node.lineno, "SC04",
                    f"`{what}` over the ranks' parts ({part}) outside the "
                    "ordered helpers: the float sum's order is not the one "
                    "every rank and device shares (C4); add the parts with "
                    "`launch.mesh._rank_sum` or `ref.ordered_sum`."))
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(scope)
    return findings


def check_module(mod: Module, graph: CallGraph) -> list[Finding]:
    out: list[Finding] = []
    out += _check_sc01(mod, graph)
    out += _check_sc04(mod)
    out += _check_sc06(mod)
    out += _check_sc07(mod)
    out += _check_sc09(mod)
    out += _check_sc10(mod)
    return out
