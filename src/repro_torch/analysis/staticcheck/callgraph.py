"""Best-effort call graph over the scanned modules, rooted at the kernel
wrappers and at the regions that must not wait for the device.

SC01's host-sync rule only makes sense where a wait costs the card: a
``float()`` in a CLI printout is fine, the same call in a function a kernel
wrapper calls stalls every launch.  The graph is an over-approximation
built from names, as the reference's:

* roots: every function of ``kernels/<name>/kernel.py`` and
  ``kernels/<name>/ops.py``; every name referenced inside the body of a
  ``with no_host_sync(...)`` or ``with torch.cuda.graph(...)`` region;
* edges: any Name or ``self.<attr>`` referenced inside a function that
  resolves to a nested def, a sibling method, a module-level def, or an
  explicitly imported def from another scanned module.

The walk does not enter ``kernels/<name>/ref.py``: ``ops.py`` reaches the
plain versions only on CPU tensors, where a host read waits for nothing.
Unresolvable references (attribute chains through objects, dynamic
dispatch) are dropped, so a miss means a violation goes unflagged, never a
false positive in host-only code.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

WRAPPER_RE = re.compile(r"(^|/)kernels/[^/]+/(kernel|ops)\.py$")
PLAIN_RE = re.compile(r"(^|/)kernels/[^/]+/ref\.py$")
REGION_NAMES = {"no_host_sync", "graph"}


def region_call(item: ast.withitem) -> bool:
    """Whether a ``with`` item opens a no-host-sync or capture region."""
    call = item.context_expr
    if not isinstance(call, ast.Call):
        return False
    f = call.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None)
    return name in REGION_NAMES


@dataclass
class FuncInfo:
    key: tuple[str, str]  # (module rel, dotted qualname)
    node: ast.FunctionDef | ast.AsyncFunctionDef
    module_rel: str
    class_name: str | None
    parent: tuple[str, str] | None
    children: dict[str, tuple[str, str]] = field(default_factory=dict)
    refs: set[str] = field(default_factory=set)  # Names + self-attr names
    is_root: bool = False


class _Collector(ast.NodeVisitor):
    def __init__(self, rel: str, graph: "CallGraph"):
        self.rel = rel
        self.graph = graph
        self.stack: list[FuncInfo] = []
        self.class_stack: list[str] = []

    def _visit_func(self, node):
        qual = ".".join(
            [*(f.key[1].rsplit(".", 1)[-1] for f in self.stack), node.name]
        )
        if self.class_stack and not self.stack:
            qual = f"{self.class_stack[-1]}.{qual}"
        info = FuncInfo(
            key=(self.rel, qual),
            node=node,
            module_rel=self.rel,
            class_name=self.class_stack[-1] if self.class_stack else None,
            parent=self.stack[-1].key if self.stack else None,
            is_root=bool(WRAPPER_RE.search(self.rel)),
        )
        self.graph.funcs[info.key] = info
        self.graph.by_node[id(node)] = info
        if self.stack:
            self.stack[-1].children[node.name] = info.key
        elif self.class_stack:
            self.graph.methods.setdefault(
                (self.rel, self.class_stack[-1], node.name), info.key
            )
        else:
            self.graph.module_defs.setdefault((self.rel, node.name), info.key)
        self.stack.append(info)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node):
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def visit_Name(self, node):
        if self.stack:
            self.stack[-1].refs.add(node.id)

    def visit_Attribute(self, node):
        if (
            self.stack
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            self.stack[-1].refs.add(node.attr)
        self.generic_visit(node)

    def _visit_with(self, node):
        if any(region_call(item) for item in node.items):
            self.graph.regions.append((self.rel, node))
            scope = self.stack[-1] if self.stack else None
            for stmt in node.body:
                self.graph.root_refs.append((self.rel, scope, stmt))
        self.generic_visit(node)

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def visit_ImportFrom(self, node):
        module = node.module or ""
        if node.level:
            # a relative import: anchor it at this module's package
            dotted = self.rel.removesuffix(".py").removeprefix("src/")
            package = dotted.split("/")[:-1]
            base = package[:len(package) - node.level + 1]
            module = ".".join(base + ([module] if module else []))
        if module:
            for alias in node.names:
                self.graph.imports.setdefault(self.rel, {})[
                    alias.asname or alias.name
                ] = (module, alias.name)
        self.generic_visit(node)


class CallGraph:
    def __init__(self, modules):
        self.funcs: dict[tuple[str, str], FuncInfo] = {}
        self.by_node: dict[int, FuncInfo] = {}
        self.module_defs: dict[tuple[str, str], tuple[str, str]] = {}
        self.methods: dict[tuple[str, str, str], tuple[str, str]] = {}
        self.imports: dict[str, dict[str, tuple[str, str]]] = {}
        self.root_refs: list = []
        self.regions: list[tuple[str, ast.With]] = []
        # module dotted path -> rel, for resolving cross-module imports
        self.mod_by_dotted: dict[str, str] = {}
        for m in modules:
            dotted = m.rel.removesuffix(".py").removesuffix("/__init__")
            dotted = dotted.removeprefix("src/").replace("/", ".")
            self.mod_by_dotted[dotted] = m.rel
            _Collector(m.rel, self).visit(m.tree)
        self._mark_region_roots()
        self.reachable_keys = self._reach()

    def _resolve(self, rel: str, scope: FuncInfo | None, name: str):
        """Resolve a bare name seen in ``rel`` (inside ``scope``) to a func."""
        s = scope
        while s is not None:
            if name in s.children:
                return s.children[name]
            s = self.funcs.get(s.parent) if s.parent else None
        if scope is not None and scope.class_name:
            meth = self.methods.get((rel, scope.class_name, name))
            if meth:
                return meth
        if (rel, name) in self.module_defs:
            return self.module_defs[(rel, name)]
        imp = self.imports.get(rel, {}).get(name)
        if imp:
            src_mod, orig = imp
            for dotted, target_rel in self.mod_by_dotted.items():
                if dotted == src_mod or dotted.endswith("." + src_mod):
                    hit = self.module_defs.get((target_rel, orig))
                    if hit:
                        return hit
        return None

    def _mark_region_roots(self):
        for rel, scope, stmt in self.root_refs:
            for n in ast.walk(stmt):
                name = None
                if isinstance(n, ast.Name):
                    name = n.id
                elif (
                    isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                ):
                    name = n.attr
                if name is None:
                    continue
                key = self._resolve(rel, scope, name)
                if key:
                    self.funcs[key].is_root = True

    def _reach(self) -> set[tuple[str, str]]:
        seen = {k for k, f in self.funcs.items()
                if f.is_root and not PLAIN_RE.search(f.module_rel)}
        frontier = list(seen)
        while frontier:
            key = frontier.pop()
            f = self.funcs[key]
            for name in f.refs:
                target = self._resolve(f.module_rel, f, name)
                if (target and target not in seen
                        and not PLAIN_RE.search(target[0])):
                    seen.add(target)
                    frontier.append(target)
        return seen

    def is_reachable(self, node: ast.AST) -> bool:
        info = self.by_node.get(id(node))
        return info is not None and info.key in self.reachable_keys
