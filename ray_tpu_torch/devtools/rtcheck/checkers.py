"""The rtcheck checker implementations (see package docstring for the
rule inventory). Ported from ``ray_tpu/devtools/rtcheck/checkers.py``.
Each checker sees every file once, accumulates local findings
immediately, and reports cross-file findings (dead registry entries) in
``finalize()``."""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.rtcheck.core import (
    Finding, Registries, SourceFile, _literal_str)

_METRIC_RE = re.compile(r"^rt_[a-z0-9_]+$")
_SITE_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_*?]+)+$")


class Checker:
    name = ""

    def __init__(self, reg: Registries):
        self.reg = reg
        self.findings: List[Finding] = []

    def add(self, path: str, line: int, msg: str) -> None:
        self.findings.append(Finding(self.name, path, line, msg))

    def visit_file(self, sf: SourceFile) -> None:  # pragma: no cover
        raise NotImplementedError

    def finalize(self) -> List[Finding]:
        return self.findings


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _config_aliases(sf: SourceFile) -> Set[str]:
    """Names this module binds to the ray_tpu_torch config module."""
    out: Set[str] = set()
    for node in sf.nodes:
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == "ray_tpu_torch":
            for a in node.names:
                if a.name == "config" or a.name.endswith(".config"):
                    out.add(a.asname or "config")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "ray_tpu_torch.config" and a.asname:
                    out.add(a.asname)
    return out


# ----------------------------------------------------------------------
# 1. config-drift
# ----------------------------------------------------------------------
class ConfigDrift(Checker):
    """Literal ``config.get``/``set_override``/``clear_override`` names
    must be defined; defined flags must be read somewhere (dead knob);
    ``define`` must carry a non-empty ``doc``."""

    name = "config-drift"

    def __init__(self, reg: Registries):
        super().__init__(reg)
        self._reads: Set[str] = set()
        self._config_sf: Optional[SourceFile] = None

    def visit_file(self, sf: SourceFile) -> None:
        if self.reg.config_flags is not None and sf.rel == self.reg.config_path:
            self._config_sf = sf
        aliases = _config_aliases(sf)
        for node in sf.nodes:
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = _call_name(node)
            flag = _literal_str(node.args[0])
            if flag is None:
                continue
            is_get = (name == "get" and isinstance(node.func, ast.Attribute)
                      and isinstance(node.func.value, ast.Name)
                      and node.func.value.id in aliases)
            is_set = name in ("set_override", "clear_override") and (
                isinstance(node.func, ast.Name)
                or (isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in aliases))
            if not (is_get or is_set):
                continue
            if is_get:
                self._reads.add(flag)
            if self.reg.config_flags is not None and \
                    flag not in self.reg.config_flags and \
                    not sf.pragma(node, "undeclared-knob"):
                self.add(sf.rel, node.lineno,
                         f"config knob {flag!r} is not config.define()d")

    def finalize(self) -> List[Finding]:
        flags = self.reg.config_flags
        if flags is not None and self._config_sf is not None:
            for flag, (line, doc) in sorted(flags.items()):
                node = _FakeNode(line)
                if flag not in self._reads and \
                        not self._config_sf.pragma(node, "dead-knob"):
                    self.add(self.reg.config_path, line,
                             f"config knob {flag!r} is defined but never "
                             f"read (config.get) anywhere in the tree")
                if not doc.strip() and \
                        not self._config_sf.pragma(node, "undocumented"):
                    self.add(self.reg.config_path, line,
                             f"config knob {flag!r} has an empty doc")
        return self.findings


class _FakeNode:
    def __init__(self, line: int):
        self.lineno = line
        self.end_lineno = line


# ----------------------------------------------------------------------
# 2. fault-sites
# ----------------------------------------------------------------------
class FaultSites(Checker):
    """``fire("a.b.c")`` literals must be registered in
    ``fault_plane.SITES``; registered sites must be fired somewhere."""

    name = "fault-sites"

    def __init__(self, reg: Registries):
        super().__init__(reg)
        self._fired: Set[str] = set()
        self._sites_sf: Optional[SourceFile] = None

    def visit_file(self, sf: SourceFile) -> None:
        if self.reg.sites is not None and sf.rel == self.reg.sites_path:
            self._sites_sf = sf
        for node in sf.nodes:
            if not isinstance(node, ast.Call) or not node.args:
                continue
            if _call_name(node) != "fire":
                continue
            site = _literal_str(node.args[0])
            if site is None or not _SITE_RE.match(site):
                continue
            self._fired.add(site)
            if self.reg.sites is not None and site not in self.reg.sites \
                    and not sf.pragma(node, "unregistered-site"):
                self.add(sf.rel, node.lineno,
                         f"fault site {site!r} is fired but not registered "
                         f"in fault_plane.SITES")

    def finalize(self) -> List[Finding]:
        if self.reg.sites is not None:
            for site, line in sorted(self.reg.sites.items()):
                if site not in self._fired and (
                        self._sites_sf is None or
                        not self._sites_sf.pragma(_FakeNode(line),
                                                  "unfired-site")):
                    self.add(self.reg.sites_path, line,
                             f"fault site {site!r} is registered in SITES "
                             f"but never fired")
        return self.findings


# ----------------------------------------------------------------------
# 3. name-drift (rt_* metrics + flight-recorder event kinds)
# ----------------------------------------------------------------------
class NameDrift(Checker):
    """Every ``rt_*`` metric-name literal outside util/metrics.py must be
    minted in ``metrics.METRICS``; every ``emit("kind")`` literal must be
    minted in ``events.EVENT_KINDS``. Registered names nobody references
    are dead."""

    name = "name-drift"

    def __init__(self, reg: Registries):
        super().__init__(reg)
        self._metric_uses: Set[str] = set()
        self._kind_uses: Set[str] = set()

    def visit_file(self, sf: SourceFile) -> None:
        in_registry = sf.rel == self.reg.metrics_path
        for node in sf.nodes:
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    _METRIC_RE.match(node.value) and not in_registry:
                self._metric_uses.add(node.value)
                if self.reg.metrics is not None and \
                        node.value not in self.reg.metrics and \
                        not sf.pragma(node, "unminted-metric"):
                    self.add(sf.rel, node.lineno,
                             f"metric name {node.value!r} is not minted in "
                             f"util/metrics.METRICS")
            if isinstance(node, ast.Call) and node.args and \
                    _call_name(node) in ("emit", "_emit"):
                kind = _literal_str(node.args[0])
                if kind is None:
                    continue
                self._kind_uses.add(kind)
                if self.reg.event_kinds is not None and \
                        kind not in self.reg.event_kinds and \
                        not sf.pragma(node, "unminted-kind"):
                    self.add(sf.rel, node.lineno,
                             f"event kind {kind!r} is not minted in "
                             f"util/events.EVENT_KINDS")

    def finalize(self) -> List[Finding]:
        if self.reg.metrics is not None:
            for name, line in sorted(self.reg.metrics.items()):
                if name not in self._metric_uses:
                    self.add(self.reg.metrics_path, line,
                             f"metric {name!r} is minted in METRICS but "
                             f"never referenced outside the registry")
        if self.reg.event_kinds is not None:
            for kind, line in sorted(self.reg.event_kinds.items()):
                if kind not in self._kind_uses:
                    self.add(self.reg.events_path, line,
                             f"event kind {kind!r} is minted in "
                             f"EVENT_KINDS but never emitted")
        return self.findings


# ----------------------------------------------------------------------
# 4. lock-blocking
# ----------------------------------------------------------------------
_LOCK_ATTRS = {"_lock", "_cv"}
_SOCKET_ATTRS = {"recv", "recv_into", "recvfrom", "send", "sendall",
                 "sendmsg", "accept", "connect", "makefile"}
_SUBPROC_ATTRS = {"Popen", "check_output", "check_call", "communicate"}
_RPC_ATTRS = {"call", "call_async", "call_batch", "call_pipelined"}


def _is_lock_ctx(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Attribute) and expr.attr in _LOCK_ATTRS and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        return True
    return isinstance(expr, ast.Name) and expr.id in _LOCK_ATTRS


def _classify_blocking(node: ast.Call) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Name):
        return "open() file I/O" if fn.id == "open" else None
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    base = fn.value.id if isinstance(fn.value, ast.Name) else ""
    if attr == "sleep":
        return "time.sleep"
    if attr in _RPC_ATTRS:
        return f"RPC .{attr}()"
    if attr == "result":
        return "future .result() wait"
    if attr in _SOCKET_ATTRS:
        return f"socket .{attr}()"
    if attr in _SUBPROC_ATTRS or (attr in ("run",) and base == "subprocess"):
        return f"subprocess .{attr}()"
    if attr == "get" and base in ("rt", "ray_tpu_torch"):
        return f"{base}.get() object wait"
    return None


_SKIP_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.Lambda)


def _iter_stmts(body: Iterable[ast.stmt]) -> Iterable[ast.stmt]:
    """Statements executed while the lock is held: recurse into compound
    statements but NOT into nested def/class bodies (those run later,
    without the lock)."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, _SKIP_SCOPES):
            continue
        for field_name in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field_name, None)
            if sub:
                yield from _iter_stmts(sub)
        for handler in getattr(stmt, "handlers", ()):
            yield from _iter_stmts(handler.body)


def _stmt_calls(stmt: ast.stmt) -> Iterable[ast.Call]:
    """Calls evaluated by this statement itself (its header expressions),
    excluding nested statements and deferred scopes (lambda bodies)."""
    stack: List[ast.AST] = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt) or \
                    isinstance(child, _SKIP_SCOPES):
                continue
            stack.append(child)


class LockBlocking(Checker):
    """No known-blocking call inside a ``with self._lock:`` /
    ``with self._cv:`` body. The conductor/daemon contracts ("does no
    RPC under self._lock") live here now, not in comments. Suppress a
    deliberate hold with ``# rtcheck: allow-blocking(reason)`` on the
    statement."""

    name = "lock-blocking"

    def __init__(self, reg: Registries):
        super().__init__(reg)
        self._seen: Set[Tuple[str, int, str]] = set()

    def visit_file(self, sf: SourceFile) -> None:
        for node in sf.nodes:
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            lock_names = [ast.unparse(i.context_expr) for i in node.items
                          if _is_lock_ctx(i.context_expr)]
            if not lock_names:
                continue
            for stmt in _iter_stmts(node.body):
                for call in _stmt_calls(stmt):
                    why = _classify_blocking(call)
                    if why is None:
                        continue
                    key = (sf.rel, call.lineno, why)
                    if key in self._seen:
                        continue  # nested with-blocks: report once
                    self._seen.add(key)
                    if sf.pragma(stmt, "blocking") or \
                            sf.pragma(call, "blocking"):
                        continue
                    self.add(sf.rel, call.lineno,
                             f"{why} while holding {lock_names[0]} "
                             f"(annotate # rtcheck: allow-blocking(why) "
                             f"if deliberate)")


# ----------------------------------------------------------------------
# 5. except-hygiene
# ----------------------------------------------------------------------
_EXIT_ALLOWED_FILES = {"fault_plane.py", "worker_main.py"}


def _mentions_base_exception(expr: Optional[ast.AST]) -> bool:
    if expr is None:
        return False
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id == "BaseException":
            return True
    return False


class ExceptHygiene(Checker):
    """Bare ``except:`` / ``except BaseException`` can swallow
    KeyboardInterrupt and worker-kill signals; each one must be annotated
    (``# noqa: BLE001`` or an rtcheck pragma) or narrowed. ``os._exit``
    bypasses finally/atexit and is reserved for the process-termination
    planes (fault_plane, worker_main)."""

    name = "except-hygiene"

    def visit_file(self, sf: SourceFile) -> None:
        for node in sf.nodes:
            if isinstance(node, ast.ExceptHandler):
                if node.type is None:
                    if not sf.pragma(node, "bare-except") and \
                            not sf.has_broad_except_mark(node):
                        self.add(sf.rel, node.lineno,
                                 "bare 'except:' (swallows "
                                 "KeyboardInterrupt/SystemExit) — narrow "
                                 "it or annotate why")
                elif _mentions_base_exception(node.type) and \
                        not sf.has_broad_except_mark(node):
                    self.add(sf.rel, node.lineno,
                             "'except BaseException' without an "
                             "annotation — narrow it or mark "
                             "# noqa: BLE001 with a reason")
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "_exit" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "os":
                if sf.path.name not in _EXIT_ALLOWED_FILES and \
                        not sf.pragma(node, "exit"):
                    self.add(sf.rel, node.lineno,
                             "os._exit outside fault_plane/worker_main "
                             "(skips finally/atexit cleanup)")


# ----------------------------------------------------------------------
# 6. thread-hygiene
# ----------------------------------------------------------------------
class ThreadHygiene(Checker):
    """Every ``threading.Thread(...)`` must pass ``name=`` (debug_state /
    py-spy profiles become unreadable with Thread-12 soup) and an explicit
    ``daemon=`` (implicit non-daemon threads hang interpreter exit)."""

    name = "thread-hygiene"

    def visit_file(self, sf: SourceFile) -> None:
        for node in sf.nodes:
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            is_thread = (isinstance(fn, ast.Name) and fn.id == "Thread") or \
                (isinstance(fn, ast.Attribute) and fn.attr == "Thread")
            if not is_thread:
                continue
            kwargs = {kw.arg for kw in node.keywords}
            missing = [k for k in ("name", "daemon") if k not in kwargs]
            if missing and not sf.pragma(node, "thread"):
                self.add(sf.rel, node.lineno,
                         f"threading.Thread without {'/'.join(missing)}=")


# ----------------------------------------------------------------------
# 7. doc-drift (PARITY.md fault-site table vs SITES)
# ----------------------------------------------------------------------
class DocDrift(Checker):
    """PARITY.md's fault-site table and ``fault_plane.SITES`` must not
    drift: every registered site appears in PARITY.md, and every site the
    r15 table lists is registered."""

    name = "doc-drift"

    def visit_file(self, sf: SourceFile) -> None:
        pass

    def finalize(self) -> List[Finding]:
        reg = self.reg
        if reg.sites is None or reg.parity_path is None or \
                not reg.parity_path.exists():
            return self.findings
        text = reg.parity_path.read_text()
        rel = str(reg.parity_path)
        for site in sorted(reg.sites):
            if site not in text:
                self.add(rel, 1, f"fault site {site!r} is registered in "
                         f"SITES but missing from PARITY.md")
        # Reverse direction: sites the dedicated table claims.
        in_table = False
        for i, line in enumerate(text.splitlines(), start=1):
            if "Fault-site registry" in line:
                in_table = True
                continue
            if in_table and line.startswith("#"):
                break
            if in_table and line.startswith("|"):
                for m in re.finditer(r"`([a-z0-9_]+(?:\.[a-z0-9_]+)+)`",
                                     line):
                    if m.group(1) not in reg.sites:
                        self.add(rel, i,
                                 f"PARITY.md fault-site table lists "
                                 f"{m.group(1)!r} which is not in SITES")
        return self.findings


def build_all(reg: Registries) -> List[Checker]:
    return [ConfigDrift(reg), FaultSites(reg), NameDrift(reg),
            LockBlocking(reg), ExceptHygiene(reg), ThreadHygiene(reg),
            DocDrift(reg)]
