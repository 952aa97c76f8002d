"""``ray_tpu_torch.devtools.rtcheck``, held to ``ray_tpu.devtools.rtcheck``
(the counterparts of ``tests/test_rtcheck.py``).

- Each fixture tree goes through the JAX checker (its sources importing
  ``ray_tpu``) and the port's (the same sources importing
  ``ray_tpu_torch``): both give the same checkers, files, lines and
  messages, and the port's findings meet the JAX test's assertions.
- The lock-order sanitizer tests run over ``ray_tpu_torch.util.lockcheck``.
- The port's committed tree has zero findings, and the CLI's exit codes.
"""

import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch import config
from ray_tpu_torch.devtools.rtcheck import core
from ray_tpu_torch.devtools.rtcheck.core import Registries, run_tree
from ray_tpu_torch.util import lockcheck

REPO = Path(__file__).resolve().parents[1]


def _write(root, files, package):
    for name, src in files.items():
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src).replace("{pkg}", package))


def _normal(findings, root):
    """(checker, path under the fixture root, line, message) of each."""
    root = str(root.resolve())
    out = []
    for f in findings:
        path = str(Path(f.path).resolve())
        out.append((f.checker, path.replace(root, "<root>"), f.line,
                    f.message.replace(root, "<root>")))
    return out


def _both(tmp_path, files, registries=None, with_doc_drift=False):
    """Run the JAX and the port's checkers over the fixture tree, each with
    its own package in the imports; assert they agree and return the
    port's findings."""
    from ray_tpu.devtools.rtcheck import core as jcore
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    _write(jroot, files, "ray_tpu")
    _write(proot, files, "ray_tpu_torch")
    jreg = preg = None
    if registries is not None:
        jreg = jcore.Registries(**registries(jroot))
        preg = Registries(**registries(proot))
    jax_found = jcore.run_tree([jroot], registries=jreg,
                               with_doc_drift=with_doc_drift)
    port_found = run_tree([proot], registries=preg,
                          with_doc_drift=with_doc_drift)
    assert _normal(port_found, proot) == _normal(jax_found, jroot)
    return port_found


def _only(findings, checker):
    return [f for f in findings if f.checker == checker]


# ----------------------------------------------------------------------
# config-drift
# ----------------------------------------------------------------------
CONFIG_PY = """
    def define(name, typ, default, doc):
        pass

    define("alpha", bool, False, "a documented, read knob")
    define("beta", int, 3, "a knob nobody reads")
    define("gamma", float, 0.0, "")
"""


def test_config_drift_directions(tmp_path):
    findings = _only(_both(tmp_path, {
        "config.py": CONFIG_PY,
        "user.py": """
            from {pkg} import config

            def f():
                config.get("alpha")
                config.get("ghost_knob")
        """,
    }), "config-drift")
    msgs = "\n".join(f.message for f in findings)
    assert "'ghost_knob' is not config.define()d" in msgs
    assert "'beta' is defined but never read" in msgs
    assert "'gamma' has an empty doc" in msgs
    assert "'alpha'" not in msgs


def test_config_drift_ignores_unrelated_get(tmp_path):
    findings = _only(_both(tmp_path, {
        "config.py": CONFIG_PY,
        "user.py": """
            from {pkg} import config

            def f(d):
                d.get("not_a_knob")
                config.get("alpha")
                config.get("beta")
                config.get("gamma")
        """,
    }), "config-drift")
    assert [f.message for f in findings] == \
        ["config knob 'gamma' has an empty doc"]


def test_config_drift_pragmas(tmp_path):
    findings = _only(_both(tmp_path, {
        "config.py": """
            def define(name, typ, default, doc):
                pass

            define("kept", int, 1, "staged knob")  # rtcheck: allow-dead-knob(wired in the next PR)
            define("bare", int, 1, "")  # rtcheck: allow-undocumented()
        """,
    }), "config-drift")
    msgs = [f.message for f in findings]
    assert not any("'kept'" in m for m in msgs)
    assert any("'bare' has an empty doc" in m for m in msgs)


def test_config_drift_sees_the_ports_config_import(tmp_path):
    """The JAX checker binds only ``ray_tpu``'s config; the port's binds
    ``ray_tpu_torch``'s (``import ray_tpu_torch.config as c`` as well),
    which is what makes the port's tree checkable."""
    from ray_tpu.devtools.rtcheck.core import run_tree as jax_run_tree
    _write(tmp_path, {"config.py": CONFIG_PY, "user.py": """
        from ray_tpu_torch import config
        import ray_tpu_torch.config as cfg

        def f():
            config.get("alpha")
            cfg.get("beta")
            cfg.get("ghost_knob")
    """}, "")
    port = [f.message for f in _only(run_tree([tmp_path],
                                              with_doc_drift=False),
                                     "config-drift")]
    assert sorted(port) == [
        "config knob 'gamma' has an empty doc",
        "config knob 'gamma' is defined but never read (config.get) "
        "anywhere in the tree",
        "config knob 'ghost_knob' is not config.define()d"]
    jax = [f.message for f in _only(jax_run_tree([tmp_path],
                                                 with_doc_drift=False),
                                    "config-drift")]
    assert "config knob 'alpha' is defined but never read (config.get) " \
        "anywhere in the tree" in jax


# ----------------------------------------------------------------------
# fault-sites
# ----------------------------------------------------------------------
def test_fault_sites_both_directions(tmp_path):
    findings = _only(_both(tmp_path, {
        "fault_plane.py": """
            SITES = {
                "plane.op.fired": "exercised below",
                "plane.op.orphan": "registered but never fired",
            }

            def fire(site):
                pass
        """,
        "user.py": """
            from fault_plane import fire

            def f():
                fire("plane.op.fired")
                fire("plane.op.rogue")
        """,
    }), "fault-sites")
    msgs = "\n".join(f.message for f in findings)
    assert "'plane.op.rogue' is fired but not registered" in msgs
    assert "'plane.op.orphan' is registered in SITES but never fired" in msgs
    assert "plane.op.fired" not in msgs


def test_fault_sites_pragma_and_non_site_strings(tmp_path):
    findings = _only(_both(tmp_path, {
        "fault_plane.py": """
            SITES = {}

            def fire(site):
                pass
        """,
        "user.py": """
            from fault_plane import fire

            def f(gun):
                fire("plane.op.special")  # rtcheck: allow-unregistered-site(synthetic unit-test site)
                gun.fire("not a dotted site name")
        """,
    }), "fault-sites")
    assert findings == []


# ----------------------------------------------------------------------
# name-drift (metrics + event kinds)
# ----------------------------------------------------------------------
def test_name_drift_metrics_and_kinds(tmp_path):
    findings = _only(_both(tmp_path, {
        "metrics.py": """
            METRICS = {
                "rt_used": "referenced below",
                "rt_dead": "minted but never referenced",
            }
        """,
        "events.py": """
            EVENT_KINDS = {
                "op.done": "emitted below",
                "op.never": "minted but never emitted",
            }

            def emit(kind, **kw):
                pass
        """,
        "user.py": """
            from events import emit

            def f(m):
                m.inc("rt_used")
                m.inc("rt_rogue")
                emit("op.done")
                emit("op.rogue")
        """,
    }), "name-drift")
    msgs = "\n".join(f.message for f in findings)
    assert "'rt_rogue' is not minted" in msgs
    assert "'rt_dead' is minted in METRICS but never referenced" in msgs
    assert "'op.rogue' is not minted" in msgs
    assert "'op.never' is minted in EVENT_KINDS but never emitted" in msgs
    assert "rt_used" not in msgs and "'op.done'" not in msgs


# ----------------------------------------------------------------------
# lock-blocking
# ----------------------------------------------------------------------
def test_lock_blocking_positive_and_negative(tmp_path):
    findings = _only(_both(tmp_path, {
        "mod.py": """
            import time

            class Plane:
                def bad(self):
                    with self._lock:
                        time.sleep(1.0)

                def bad_rpc(self):
                    with self._cv:
                        self.client.call("method")

                def fine_outside(self):
                    time.sleep(1.0)
                    with self._lock:
                        x = 1
                    return x

                def fine_deferred(self):
                    with self._lock:
                        def later():
                            time.sleep(1.0)
                        return later
        """,
    }), "lock-blocking")
    assert len(findings) == 2
    msgs = "\n".join(f.message for f in findings)
    assert "time.sleep while holding self._lock" in msgs
    assert "RPC .call() while holding self._cv" in msgs


def test_lock_blocking_pragma_trailing_and_above(tmp_path):
    findings = _only(_both(tmp_path, {
        "mod.py": """
            import time

            class Plane:
                def a(self):
                    with self._lock:
                        time.sleep(0.1)  # rtcheck: allow-blocking(bounded backoff, lock is test-only)

                def b(self):
                    with self._lock:
                        # rtcheck: allow-blocking(wire lock serializes the socket)
                        self.sock.sendall(b"x")

                def c(self):
                    with self._lock:
                        time.sleep(0.1)  # rtcheck: allow-blocking()
        """,
    }), "lock-blocking")
    assert len(findings) == 1
    assert findings[0].line == 16


# ----------------------------------------------------------------------
# except-hygiene
# ----------------------------------------------------------------------
def test_except_hygiene(tmp_path):
    findings = _only(_both(tmp_path, {
        "mod.py": """
            import os

            def f():
                try:
                    pass
                except:
                    pass
                try:
                    pass
                except BaseException:
                    raise
                try:
                    pass
                except BaseException:  # noqa: BLE001 - cleanup then re-raise
                    raise
                try:
                    pass
                except ValueError:
                    pass
                os._exit(1)
        """,
    }), "except-hygiene")
    msgs = [f.message for f in findings]
    assert len(msgs) == 3
    assert any("bare 'except:'" in m for m in msgs)
    assert any("'except BaseException' without an annotation" in m
               for m in msgs)
    assert any("os._exit outside fault_plane/worker_main" in m for m in msgs)


def test_except_hygiene_exit_allowed_in_fault_plane(tmp_path):
    findings = _only(_both(tmp_path, {
        "fault_plane.py": """
            import os

            def crash():
                os._exit(17)
        """,
    }), "except-hygiene")
    assert findings == []


# ----------------------------------------------------------------------
# thread-hygiene
# ----------------------------------------------------------------------
def test_thread_hygiene(tmp_path):
    findings = _only(_both(tmp_path, {
        "mod.py": """
            import threading

            def f():
                threading.Thread(target=f)
                threading.Thread(target=f, daemon=True)
                threading.Thread(target=f, name="ok", daemon=True)
                threading.Thread(target=f)  # rtcheck: allow-thread(framework-owned thread)
        """,
    }), "thread-hygiene")
    msgs = [f.message for f in findings]
    assert msgs == ["threading.Thread without name/daemon=",
                    "threading.Thread without name="]


# ----------------------------------------------------------------------
# doc-drift (fault-site table vs SITES)
# ----------------------------------------------------------------------
_PARITY = """
    # parity

    ### Fault-site registry

    | Layer | Sites |
    |---|---|
    | plane | `plane.op.fired` `plane.op.phantom` |

    ## next section
"""


def test_doc_drift_both_directions(tmp_path):
    def registries(root):
        return dict(sites={"plane.op.fired": 1, "plane.op.undoc": 2},
                    sites_path="fault_plane.py",
                    parity_path=root / "PARITY.md")

    findings = _only(_both(tmp_path, {"PARITY.md": _PARITY},
                           registries=registries, with_doc_drift=True),
                     "doc-drift")
    msgs = "\n".join(f.message for f in findings)
    assert "'plane.op.undoc' is registered in SITES but missing" in msgs
    assert "table lists 'plane.op.phantom' which is not in SITES" in msgs


# ----------------------------------------------------------------------
# lock-order sanitizer (runtime), over the port's lockcheck
# ----------------------------------------------------------------------
@pytest.fixture
def armed_lockcheck():
    lockcheck.reset()
    config.set_override("lockcheck_enabled", True)
    config.set_override("lockcheck_hold_s", 10.0)
    try:
        yield
    finally:
        config.clear_override("lockcheck_enabled")
        config.clear_override("lockcheck_hold_s")
        lockcheck.reset()


def test_lockcheck_detects_ab_ba_cycle(armed_lockcheck):
    a = lockcheck.named_lock("unit.A")
    b = lockcheck.named_lock("unit.B")
    with a:
        with b:
            pass
    assert lockcheck.cycles() == []
    with b:
        with a:
            pass
    cycles = lockcheck.cycles()
    assert len(cycles) == 1
    assert set(cycles[0]) == {"unit.A", "unit.B"}
    with b:
        with a:
            pass
    assert len(lockcheck.cycles()) == 1


def test_lockcheck_long_hold_and_condition(armed_lockcheck):
    config.set_override("lockcheck_hold_s", 0.02)
    try:
        slow = lockcheck.named_lock("unit.slow")
        with slow:
            time.sleep(0.06)
        holds = lockcheck.long_holds()
        assert [name for name, _ in holds] == ["unit.slow"]
        assert holds[0][1] >= 0.02

        cv = threading.Condition(lockcheck.named_lock("unit.cv"))
        done = []

        def waiter():
            with cv:
                cv.wait_for(lambda: done, timeout=5)

        t = threading.Thread(target=waiter, name="unit-cv-waiter",
                             daemon=True)
        t.start()
        time.sleep(0.05)
        with cv:
            done.append(1)
            cv.notify_all()
        t.join(timeout=5)
        assert not t.is_alive()
        assert lockcheck.cycles() == []
    finally:
        config.clear_override("lockcheck_hold_s")


def test_lockcheck_disabled_records_nothing():
    lockcheck.reset()
    a = lockcheck.named_lock("unit.off.A")
    b = lockcheck.named_lock("unit.off.B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert lockcheck.edges() == {}
    assert lockcheck.cycles() == []


# ----------------------------------------------------------------------
# self-enforcement + CLI
# ----------------------------------------------------------------------
def test_committed_port_tree_is_clean():
    """The port's package has zero findings. ``doc-drift`` runs too: it
    finds the repo's ``PARITY.md`` by walking up from the package."""
    pkg = Path(ray_tpu_torch.__file__).parent
    assert core.default_tree_root() == pkg
    assert core._find_parity([pkg]) == REPO / "PARITY.md"
    findings = run_tree([pkg])
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "mod.py"
    bad.write_text("import threading\nthreading.Thread(target=print)\n")
    assert core.main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "[thread-hygiene]" in out
    assert core.main(["--json", str(Path(ray_tpu_torch.__file__).parent)]) \
        == 0
    assert capsys.readouterr().out.strip() == "[]"


def test_module_cli_scans_the_port_and_exits_zero():
    """``python -m ray_tpu_torch.devtools.rtcheck`` with no path scans the
    port's package and exits 0 with 0 findings."""
    out = subprocess.run([sys.executable, "-m",
                          "ray_tpu_torch.devtools.rtcheck"],
                         capture_output=True, text=True, cwd=str(REPO),
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        "rtcheck: 0 finding(s) over 1 path(s)"
