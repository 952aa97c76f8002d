"""rtcheck driver: file loading, pragma parsing, registry extraction,
checker orchestration. Ported from ``ray_tpu/devtools/rtcheck/core.py``.

Everything is AST-based and import-free: the scanned tree is never
executed, so the checker runs in a bare interpreter in well under the
10s wall-time budget the microbench gates (``rtcheck_full_tree``).

Cross-file invariants (dead knobs, unfired sites, unused metric names)
need the whole package in view, so they only run when the scan covers
the registry sources themselves (``config.py``, ``fault_plane.py``,
``metrics.py``, ``events.py``). A partial scan — one subdirectory —
still runs every local checker plus the "undeclared name" direction of
the registry checkers.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PRAGMA_RE = re.compile(r"#\s*rtcheck:\s*allow-([a-z-]+)\(([^)]*)\)")
_NOQA_BROAD_RE = re.compile(r"#\s*noqa:.*\bBLE001\b")


@dataclass(frozen=True)
class Finding:
    checker: str
    path: str          # repo-relative (or as-given) file path
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


class SourceFile:
    """One parsed module plus its pragma index."""

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        # Every node once, in ``ast.walk``'s order: each checker iterates
        # this list instead of walking the tree again (the JAX checkers
        # walk it once each, which is most of a scan's time).
        self.nodes = list(ast.walk(self.tree))
        # line -> [(rule, reason)]; comment-only pragma lines also cover
        # the statement starting on the next line.
        self._pragmas: Dict[int, List[Tuple[str, str]]] = {}
        self._own_line_pragmas: set = set()
        for i, line in enumerate(self.lines, start=1):
            if "rtcheck:" in line:
                for m in _PRAGMA_RE.finditer(line):
                    self._pragmas.setdefault(i, []).append(
                        (m.group(1), m.group(2).strip()))
                if line.lstrip().startswith("#"):
                    self._own_line_pragmas.add(i)

    def pragma(self, node: ast.AST, rule: str) -> Optional[str]:
        """Reason string if any line of ``node``'s statement span carries
        ``# rtcheck: allow-<rule>(reason)`` (trailing, or on a comment
        line directly above); None otherwise. An empty reason does NOT
        suppress — suppressions must say why."""
        lo = getattr(node, "lineno", 0)
        hi = getattr(node, "end_lineno", lo)
        first = lo - 1 if lo - 1 in self._own_line_pragmas else lo
        for ln in range(first, hi + 1):
            for rule_name, reason in self._pragmas.get(ln, ()):
                if rule_name == rule and reason:
                    return reason
        return None

    def has_broad_except_mark(self, node: ast.AST) -> bool:
        lo = getattr(node, "lineno", 0)
        line = self.lines[lo - 1] if 0 < lo <= len(self.lines) else ""
        return bool(_NOQA_BROAD_RE.search(line)) or bool(
            self.pragma(node, "broad-except"))


@dataclass
class Registries:
    """Canonical-name registries extracted from the scanned tree (or
    injected by tests). ``None`` means the registry source was not in
    the scan, so its dead-entry direction is skipped."""
    config_flags: Optional[Dict[str, Tuple[int, str]]] = None  # name -> (line, doc)
    sites: Optional[Dict[str, int]] = None                     # name -> line
    metrics: Optional[Dict[str, int]] = None
    event_kinds: Optional[Dict[str, int]] = None
    config_path: str = ""
    sites_path: str = ""
    metrics_path: str = ""
    events_path: str = ""
    parity_path: Optional[Path] = None


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _extract_define_calls(sf: SourceFile) -> Dict[str, Tuple[int, str]]:
    """``define("name", type, default, doc)`` calls in a config module."""
    out: Dict[str, Tuple[int, str]] = {}
    for node in sf.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        if name != "define" or not node.args:
            continue
        flag = _literal_str(node.args[0])
        if flag is None:
            continue
        doc = ""
        for kw in node.keywords:
            if kw.arg == "doc":
                doc = _literal_str(kw.value) or ""
        if len(node.args) >= 4:
            doc = _literal_str(node.args[3]) or doc
        out[flag] = (node.lineno, doc)
    return out


def _extract_dict_assign(sf: SourceFile, target: str) -> Optional[Dict[str, int]]:
    """Literal string keys of a module-level ``TARGET = {...}`` (or
    ``TARGET: ... = {...}``) assignment."""
    for node in sf.tree.body:
        value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == target:
            value = node.value
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and \
                node.target.id == target:
            value = node.value
        if isinstance(value, ast.Dict):
            out = {}
            for k in value.keys:
                s = _literal_str(k)
                if s is not None:
                    out[s] = k.lineno
            return out
    return None


def load_files(paths: List[Path]) -> List[SourceFile]:
    files: List[SourceFile] = []
    seen = set()
    for p in paths:
        p = Path(p)
        candidates = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in candidates:
            if "__pycache__" in f.parts or f in seen:
                continue
            seen.add(f)
            try:
                rel = str(f.relative_to(Path.cwd()))
            except ValueError:
                rel = str(f)
            files.append(SourceFile(f, rel))
    return files


def extract_registries(files: List[SourceFile]) -> Registries:
    reg = Registries()
    for sf in files:
        name = sf.path.name
        if name == "config.py" and "define(" in sf.text and \
                reg.config_flags is None:
            flags = _extract_define_calls(sf)
            if flags:
                reg.config_flags, reg.config_path = flags, sf.rel
        elif name == "fault_plane.py" and reg.sites is None:
            reg.sites = _extract_dict_assign(sf, "SITES")
            reg.sites_path = sf.rel
        elif name == "metrics.py" and reg.metrics is None:
            reg.metrics = _extract_dict_assign(sf, "METRICS")
            reg.metrics_path = sf.rel
        elif name == "events.py" and reg.event_kinds is None:
            reg.event_kinds = _extract_dict_assign(sf, "EVENT_KINDS")
            reg.events_path = sf.rel
    return reg


def _find_parity(paths: List[Path]) -> Optional[Path]:
    for p in paths:
        cur = Path(p).resolve()
        if cur.is_file():
            cur = cur.parent
        for d in [cur, *cur.parents]:
            cand = d / "PARITY.md"
            if cand.exists():
                return cand
    return None


def run_tree(paths: List, registries: Optional[Registries] = None,
             with_doc_drift: bool = True) -> List[Finding]:
    """Run every checker over ``paths`` (files or directories). Returns
    all findings, sorted by (path, line)."""
    from ray_tpu_torch.devtools.rtcheck import checkers

    paths = [Path(p) for p in paths]
    files = load_files(paths)
    reg = registries if registries is not None else extract_registries(files)
    if with_doc_drift and reg.parity_path is None:
        reg.parity_path = _find_parity(paths)
    findings: List[Finding] = []
    for checker in checkers.build_all(reg):
        for sf in files:
            checker.visit_file(sf)
        findings.extend(checker.finalize())
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    return findings


def default_tree_root() -> Path:
    """The installed ray_tpu_torch package root (what ``python -m
    ray_tpu_torch.devtools.rtcheck`` scans when no path is given)."""
    return Path(__file__).resolve().parents[2]


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(
        "rtcheck",
        description="ray_tpu_torch distributed-correctness checkers")
    ap.add_argument("paths", nargs="*", help="files/dirs (default: the "
                    "installed ray_tpu_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    args = ap.parse_args(argv)
    paths = args.paths or [default_tree_root()]
    findings = run_tree(paths)
    if args.json:
        print(_json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"rtcheck: {len(findings)} finding(s) over "
              f"{len(paths)} path(s)")
    return 1 if findings else 0
