"""Findings, ignore comments, baseline ratchet, and the scan driver (the
reference's, without the drain contract of the tests)."""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

IGNORE_RE = re.compile(r"#\s*staticcheck:\s*ignore\[([A-Z0-9,\s]+)\]")


@dataclass(frozen=True, order=True)
class Finding:
    path: str  # repo-root-relative, posix separators
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class Module:
    """One parsed source file plus its per-line ignore directives."""

    path: Path
    rel: str
    source: str
    tree: ast.Module
    ignores: dict[int, set[str]] = field(default_factory=dict)

    def ignored(self, line: int, rule: str) -> bool:
        return rule in self.ignores.get(line, ())


def _parse_ignores(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for lineno, text in enumerate(source.splitlines(), 1):
        m = IGNORE_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(lineno, set()).update(rules)
        if not text.split("#", 1)[0].strip():
            # comment on its own line: applies to the statement below it
            out.setdefault(lineno + 1, set()).update(rules)
    return out


def _infer_repo_root(path: Path) -> Path:
    """Parent of the nearest ``src`` ancestor, so findings read ``src/...``."""
    p = path.resolve()
    for anc in [p, *p.parents]:
        if anc.name == "src":
            return anc.parent
        if (anc / "src").is_dir():
            return anc
    return p if p.is_dir() else p.parent


def _collect_files(paths: list[Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    # dedupe, keep order
    seen: set[Path] = set()
    out = []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(r)
    return out


def load_modules(paths: list[Path], repo_root: Path | None = None):
    repo_root = (repo_root or _infer_repo_root(paths[0])).resolve()
    modules: list[Module] = []
    for f in _collect_files(paths):
        source = f.read_text()
        try:
            tree = ast.parse(source, filename=str(f))
        except SyntaxError:
            continue  # ruff's E9 owns syntax errors
        try:
            rel = f.relative_to(repo_root).as_posix()
        except ValueError:
            rel = f.as_posix()
        modules.append(Module(f, rel, source, tree, _parse_ignores(source)))
    return modules, repo_root


def scan(paths: list[Path], repo_root: Path | None = None) -> list[Finding]:
    """Run all rules over ``paths``; returns sorted, ignore-filtered findings."""
    from . import rules
    from .callgraph import CallGraph

    paths = [Path(p) for p in paths]
    modules, repo_root = load_modules(paths, repo_root)
    graph = CallGraph(modules)

    findings: list[Finding] = []
    for mod in modules:
        findings.extend(rules.check_module(mod, graph))
    findings.extend(rules.check_kernel_contract(modules, repo_root))

    by_rel = {m.rel: m for m in modules}
    kept = [
        f
        for f in findings
        if not (f.path in by_rel and by_rel[f.path].ignored(f.line, f.rule))
    ]
    return sorted(set(kept))


# ---------------------------------------------------------------------------
# Baseline: a ratchet of grandfathered findings, keyed (path, rule) -> count.
# Count-based keys survive unrelated line drift; the goal state is an empty
# file, which grandfathers nothing.
# ---------------------------------------------------------------------------

def summarize(findings: list[Finding]) -> dict[tuple[str, str], int]:
    out: dict[tuple[str, str], int] = {}
    for f in findings:
        k = (f.path, f.rule)
        out[k] = out.get(k, 0) + 1
    return out


def load_baseline(path: Path) -> dict[tuple[str, str], int]:
    out: dict[tuple[str, str], int] = {}
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 3:
            continue
        fpath, rule, count = parts
        out[(fpath, rule)] = int(count)
    return out


def write_baseline(findings: list[Finding], path: Path) -> None:
    lines = ["# staticcheck baseline of the port — grandfathered findings "
             "(path rule count)"]
    for (fpath, rule), count in sorted(summarize(findings).items()):
        lines.append(f"{fpath} {rule} {count}")
    path.write_text("\n".join(lines) + "\n")


def new_findings(
    findings: list[Finding], baseline: dict[tuple[str, str], int]
) -> list[Finding]:
    """Findings beyond the grandfathered per-(path, rule) budget."""
    seen: dict[tuple[str, str], int] = {}
    out = []
    for f in sorted(findings):
        k = (f.path, f.rule)
        seen[k] = seen.get(k, 0) + 1
        if seen[k] > baseline.get(k, 0):
            out.append(f)
    return out
