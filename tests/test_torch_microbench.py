"""``ray_tpu_torch/cluster/microbench.py``, the control plane's
microbenchmarks, held to ``ray_tpu/cluster/microbench.py``.

- The ``--compare`` regression gate (``tests/test_exec_plane_fastpath.py``'s
  ``test_microbench_compare_gate``) gives the same verdicts and prints the
  same table through both packages on the same files.
- The result names, read from both sources' ASTs, are the JAX suite's but
  the port's listed divergences.
- ``run_microbenchmark`` refuses an address and otherwise reaches ``main``
  (monkeypatched: the suite itself runs for minutes, on the card machine in
  ``chip_smoke.py`` phase 34).
- The suite's remote callables are module-level (the port's pickler sends
  them by import path), and nothing sets a platform variable.
"""

import ast
import importlib
import json
from pathlib import Path

import pytest

from ray_tpu_torch.cluster import microbench

REPO = Path(__file__).resolve().parents[1]

OLD = {"results": {"task_roundtrip_per_sec": 1000.0,
                   "put_get_100mb_gb_per_sec": 5.0,
                   "retired_metric_per_sec": 7.0,
                   "pipeline_1f1b_efficiency": 0.7,
                   "host_cpus": 1}}
GOOD = {"results": {"task_roundtrip_per_sec": 900.0,
                    "put_get_100mb_gb_per_sec": 5.2,
                    "brand_new_metric_per_sec": 3.0,
                    "pipeline_1f1b_efficiency": 0.69,
                    "host_cpus": 64}}
BAD = {"results": {"task_roundtrip_per_sec": 400.0,
                   "put_get_100mb_gb_per_sec": 5.2,
                   "pipeline_1f1b_efficiency": 0.5}}


def _gate(module, tmp_path, capsys):
    """Both verdict paths of the gate through one package's module: the
    regressions and exit codes, and everything it printed."""
    regressions = (module.compare_results(OLD, GOOD, 0.8),
                   module.compare_results(OLD, BAD, 0.8),
                   module.compare_results(OLD["results"], BAD["results"],
                                          0.8))
    paths = {}
    for name, payload in (("o", OLD), ("n", GOOD), ("b", BAD)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(payload))
    codes = (module.run_compare(str(paths["o"]), str(paths["n"]), 0.8),
             module.run_compare(str(paths["o"]), str(paths["b"]), 0.8),
             module.main(["--compare", str(paths["o"]), str(paths["b"]),
                          "--tolerance", "0.3"]))
    printed = capsys.readouterr().out.replace(str(tmp_path), "<tmp>")
    return regressions, codes, printed


def test_compare_gate_matches_the_jax_gate(tmp_path, capsys):
    jax_mb = importlib.import_module("ray_tpu.cluster.microbench")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _gate(microbench, tmp_path / "port", capsys)
    ref = _gate(jax_mb, tmp_path / "jax", capsys)
    assert port == ref
    # The JAX test's assertions, on the port's gate.
    ok, bad, bare = port[0]
    assert ok == []
    assert [r[0] for r in bad] == ["pipeline_1f1b_efficiency",
                                   "task_roundtrip_per_sec"]
    assert bare == bad
    assert port[1] == (0, 1, 0)


def _result_names(path):
    """The string keys a module's source assigns into ``results``."""
    tree = ast.parse(Path(path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Subscript) and \
                        isinstance(target.value, ast.Name) and \
                        target.value.id == "results" and \
                        isinstance(target.slice, ast.Constant):
                    names.append((node.lineno, target.slice.value))
    return [name for _, name in sorted(names)]


def test_result_names_are_the_jax_suites_but_the_divergences():
    jax_names = _result_names(REPO / "ray_tpu" / "cluster" / "microbench.py")
    port_names = _result_names(REPO / "ray_tpu_torch" / "cluster"
                               / "microbench.py")
    assert len(jax_names) == 41 == len(set(jax_names))
    assert tuple(jax_names) == microbench.RESULT_NAMES
    assert set(microbench.DIVERGENCES) <= set(jax_names)
    assert all(reason.strip() for reason in microbench.DIVERGENCES.values())
    assert port_names == [n for n in jax_names
                          if n not in microbench.DIVERGENCES]


def test_run_microbenchmark_refuses_an_address(monkeypatch):
    monkeypatch.setattr(microbench, "main", lambda argv=None: pytest.fail(
        "the suite ran although an address was given"))
    with pytest.raises(SystemExit) as e:
        microbench.run_microbenchmark(address="127.0.0.1:6380")
    assert "drop --address" in str(e.value.code)


def test_run_microbenchmark_reaches_main(monkeypatch):
    calls = []
    monkeypatch.setattr(microbench, "main",
                        lambda argv=None: calls.append(argv) or 0)
    assert microbench.run_microbenchmark() == 0
    assert calls == [[]]


@pytest.mark.parametrize("name", ["nop", "echo", "Counter", "Echo", "Stage",
                                  "bench_fn"])
def test_suite_callables_pickle_by_import_path(name):
    """The callables the suite sends to workers live at module level, so
    the port's pickler sends them by import path and loads them back as
    the same objects (the JAX suite nests them in ``main``)."""
    from ray_tpu_torch.core import serialization
    obj = getattr(microbench, name)
    assert obj.__qualname__ == name
    assert serialization.loads(serialization.dumps(obj)) is obj


def test_nothing_sets_a_platform_variable():
    src = (REPO / "ray_tpu_torch" / "cluster" / "microbench.py").read_text()
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "JAX_PLATFORMS" not in node.value
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("setdefault", "putenv") or \
                ast.unparse(node.value) != "os.environ"
