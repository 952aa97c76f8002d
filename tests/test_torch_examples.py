"""``examples_torch/``: the port's five examples stay runnable on the CPU.

Each runs with ``--device cpu`` in a fresh process, one at a time, as
``tests/test_examples.py`` runs the JAX ones (``runpy``, a faulthandler dump
shortly before the time limit). Each prints the lines that
``tests/test_examples.py`` looks for in its JAX twin; ``01`` and ``04``
print what the JAX ones print (``01``'s ``first ready`` line is whichever of
two tasks finished first, in either package), which this file checks by
running the JAX twins too.
"""

import os
import re
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Examples spawn whole clusters: one at a time, with a budget scaled to the
# host, as tests/test_examples.py does.
_serial = threading.Lock()


def _run(directory, name, *args, timeout=300):
    timeout = timeout * min(2, max(1, 4 // max(os.cpu_count() or 1, 1)))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    wrapper = (
        "import faulthandler, runpy, sys;"
        f"faulthandler.dump_traceback_later({timeout - 15}, exit=True);"
        f"sys.argv=[{name!r}, *{list(args)!r}];"
        f"runpy.run_path({os.path.join(REPO, directory, name)!r}, "
        "run_name='__main__')"
    )
    with _serial:
        out = subprocess.run(
            [sys.executable, "-c", wrapper],
            capture_output=True, text=True, timeout=timeout, env=env,
            cwd=REPO)
    assert out.returncode == 0, f"{name} failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def _port(name, *args):
    return _run("examples_torch", name, "--device", "cpu", *args)


def test_example_core_api_prints_what_jax_prints():
    out = _port("01_core_api.py")
    assert "squares: [0, 1, 4, 9, 16, 25, 36, 49]" in out
    assert "chained: 81" in out
    assert "count: 5" in out
    want = _run("examples", "01_core_api.py")
    first = [ln for ln in out.splitlines() if ln.startswith("first ready:")]
    assert len(first) == 1 and first[0] in ("first ready: 4",
                                            "first ready: 9")

    def rest(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith("first ready:")]
    assert rest(out) == rest(want)


def test_example_train_lm_multichip():
    out = _port("02_train_lm_multichip.py")
    losses = [float(x) for x in re.findall(r"step \d: loss=([0-9.]+)", out)]
    assert "step 4: loss=" in out and len(losses) == 5
    assert losses[-1] < losses[0]
    assert "ranks: 8, mesh: {'dp': 4, 'tp': 2}" in out
    # a weight sharded on tp, replicated on dp
    assert re.search(r"sharding example: \S+: \[Replicate\(\), Shard\(dim="
                     r"\d\)\] over \('dp', 'tp'\)", out), out


def test_example_serve_lm():
    out = _port("03_serve_lm.py")
    reply = next(ln for ln in out.splitlines() if "generated_tokens" in ln)
    tokens = re.search(r"'generated_tokens': \[([^\]]*)\]", reply).group(1)
    assert len(tokens.split(",")) == 16
    assert "'prompt': 'gpu'" in reply


def test_example_serve_lm_in_process():
    out = _port("03_serve_lm.py", "--local-mode")
    assert "'generated_tokens': [" in out


def test_example_data_pipeline_prints_what_jax_prints():
    out = _port("04_data_pipeline.py")
    assert "packed sequences:" in out
    assert "rows" in out
    assert out.splitlines() == _run("examples",
                                    "04_data_pipeline.py").splitlines()


def test_example_rl_cartpole():
    out = _port("05_rl_cartpole.py")
    iters = re.findall(r"iter (\d): reward=[0-9.]+ steps=(\d+)", out)
    assert [int(i) for i, _ in iters] == list(range(5))
    assert int(iters[-1][1]) == 5 * 2 * 8 * 64   # the JAX config's steps
    assert "checkpoint:" in out
