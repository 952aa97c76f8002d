"""The port's cluster runtime against the JAX package's, program by program.

A fixed list of programs runs first on a JAX ``Cluster`` (``ray_tpu``),
which is then shut down, then on the port's (``ray_tpu_torch``): each
program takes the package's API module and its ``Cluster`` and returns
plain values or an exception's class name. Values and class names must be
equal. Both runs happen once per test run (``_once``: the xdist workers
share one pickle of the results), so no two clusters are ever alive in one
process. The one test of the slice as a whole is here too: a CPU actor in a
port worker process runs the small LM's greedy ``generate`` from JAX's
weights, sent through the object store, and must give the JAX tokens.

The JAX cluster's workers get this module's functions and classes by
value (the module is registered with cloudpickle's pickle-by-value for the
JAX run); the port's workers import the module by name. So it imports JAX
only inside functions, and its remote functions and actor classes are
plain module-level definitions that each program wraps with its package's
``remote``.
"""

import fcntl
import os
import pickle
import time

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# plain functions and classes, wrapped by each package's ``remote``
# ---------------------------------------------------------------------------


def plus_one(x):
    return x + 1


def fail_with_value_error(x):
    raise ValueError(f"bad input {x}")


def split_three(x):
    return x, x * 2, x * 3


def identity(x):
    return x


def nap(t):
    time.sleep(t)
    return t


def node_of_task():
    import importlib
    pkg = os.environ.get("PARITY_PKG") or "ray_tpu_torch"
    return importlib.import_module(pkg).get_runtime_context().node_id


class Accumulator:
    def __init__(self, start):
        self.values = [start]

    def push(self, v):
        self.values.append(v)
        return list(self.values)

    def ping(self):
        return "pong"


class LMActor:
    """The port's small LM in a worker process, its weights converted from
    the JAX tree that came through the object store."""

    def __init__(self, jax_numpy_params, cfg_kw):
        import torch

        from ray_tpu_torch.models import convert
        from ray_tpu_torch.models import transformer as ttf
        torch.set_num_threads(1)
        self.cfg = ttf.TransformerConfig(dtype=torch.float32, **cfg_kw)
        self.params = convert.params_from_jax(jax_numpy_params, self.cfg,
                                              device="cpu")

    def generate(self, prompt, n):
        import importlib

        import torch
        tgen = importlib.import_module("ray_tpu_torch.models.generate")
        out = tgen.generate(self.params, torch.from_numpy(np.array(prompt)),
                            self.cfg, max_new_tokens=n, temperature=0.0,
                            device="cpu")
        return out.numpy()


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------


def _arrays_as_values(x):
    """An array or tensor of either package -> (dtype name, shape, float32
    values), so the two packages' host types compare."""
    dtype = str(x.dtype).replace("torch.", "")
    if type(x).__module__.startswith("torch"):
        vals = x.float().numpy()
    else:
        vals = np.asarray(x).astype(np.float32)
    return dtype, tuple(x.shape), vals.tolist()


def prog_task_chain(rt, cluster, pkg):
    f = rt.remote(plus_one)
    ref = f.remote(1)
    for _ in range(4):
        ref = f.remote(ref)
    return rt.get(ref, timeout=60)


def prog_num_returns(rt, cluster, pkg):
    refs = rt.remote(num_returns=3)(split_three).remote(5)
    return [len(refs), rt.get(list(refs), timeout=60)]


def prog_error_and_cause(rt, cluster, pkg):
    try:
        rt.get(rt.remote(fail_with_value_error).remote(7), timeout=60)
    except Exception as e:  # noqa: BLE001
        cause = getattr(e, "cause", None)
        return [type(e).__name__, type(cause).__name__, str(cause)]
    return "no error"


def prog_actor_ordering(rt, cluster, pkg):
    a = rt.remote(Accumulator).remote(0)
    out = rt.get([a.push.remote(i) for i in range(1, 6)], timeout=60)
    rt.kill(a)
    return out


def prog_named_actor(rt, cluster, pkg):
    a = rt.remote(Accumulator).options(name="parity-acc").remote(10)
    rt.get(a.push.remote(11), timeout=60)
    b = rt.get_actor("parity-acc")
    out = rt.get(b.push.remote(12), timeout=60)
    rt.kill(a)
    return out


def prog_kill_then_call(rt, cluster, pkg):
    a = rt.remote(Accumulator).remote(0)
    assert rt.get(a.ping.remote(), timeout=60) == "pong"
    rt.kill(a)
    time.sleep(0.5)
    try:
        rt.get(a.ping.remote(), timeout=10)
    except Exception as e:  # noqa: BLE001
        return type(e).__name__
    return "no error"


def prog_numpy_dict(rt, cluster, pkg):
    value = {"a": np.arange(12, dtype=np.int64).reshape(3, 4),
             "b": np.linspace(0.0, 1.0, 5, dtype=np.float32), "c": "text"}
    back = rt.get(rt.put(value), timeout=60)
    through = rt.get(rt.remote(identity).remote(value), timeout=60)
    return [{k: (v.tolist(), str(v.dtype)) if hasattr(v, "dtype") else v
             for k, v in d.items()} for d in (back, through)]


def _framework_array(pkg, dtype):
    """The package's own array: a jax.Array for the JAX run, a torch tensor
    for the port's, from the same numpy values."""
    values = np.linspace(-2.0, 2.0, 24, dtype=np.float32).reshape(4, 6)
    if pkg == "ray_tpu":
        import jax.numpy as jnp
        return jnp.asarray(values, dtype={"f32": jnp.float32,
                                          "bf16": jnp.bfloat16}[dtype])
    import torch
    return torch.from_numpy(values).to({"f32": torch.float32,
                                        "bf16": torch.bfloat16}[dtype])


def prog_cpu_tensor(rt, cluster, pkg):
    x = _framework_array(pkg, "f32")
    back = rt.get(rt.put(x), timeout=60)
    through = rt.get(rt.remote(identity).remote(x), timeout=60)
    return [_arrays_as_values(back), _arrays_as_values(through)]


def prog_bf16_tensor(rt, cluster, pkg):
    x = _framework_array(pkg, "bf16")
    back = rt.get(rt.put(x), timeout=60)
    return _arrays_as_values(back)


def prog_wait_timeout(rt, cluster, pkg):
    f = rt.remote(nap)
    fast, slow = f.remote(0.0), f.remote(3.0)
    rt.get(fast, timeout=60)
    ready, pending = rt.wait([fast, slow], num_returns=2, timeout=0.5)
    return [ready == [fast], pending == [slow]]


def prog_spillback(rt, cluster, pkg):
    node2 = cluster.add_node(num_cpus=2, resources={"special": 1.0})
    cluster.wait_for_nodes(2)
    try:
        f = rt.remote(resources={"special": 1.0}, num_cpus=1)(node_of_task)
        return rt.get(f.remote(), timeout=60) == node2.node_id
    finally:
        cluster.remove_node(node2, graceful=True)


PROGRAMS = {name[len("prog_"):]: fn for name, fn in sorted(globals().items())
            if name.startswith("prog_")}


# ---------------------------------------------------------------------------
# running them
# ---------------------------------------------------------------------------

LM_CFG = dict(vocab_size=97, d_model=64, n_layers=3, n_heads=4,
              n_kv_heads=2, max_seq=64, attn_impl="reference")


def _run_all(pkg, rt, cluster, extra=None):
    out = {}
    for name, prog in PROGRAMS.items():
        try:
            out[name] = ("value", prog(rt, cluster, pkg))
        except Exception as e:  # noqa: BLE001
            out[name] = ("raised", type(e).__name__, str(e)[:300])
    if extra is not None:
        out.update(extra(rt))
    return out


def _jax_run():
    import sys

    import cloudpickle

    import ray_tpu
    from ray_tpu.cluster.cluster_utils import Cluster
    from ray_tpu.core import api
    from ray_tpu.core.runtime_cluster import ClusterRuntime
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    os.environ["PARITY_PKG"] = "ray_tpu"
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    try:
        api._runtime = ClusterRuntime(address=c.address)
        try:
            return _run_all("ray_tpu", ray_tpu, c)
        finally:
            api._runtime.shutdown()
            api._runtime = None
    finally:
        c.shutdown()
        os.environ.pop("PARITY_PKG", None)
        cloudpickle.unregister_pickle_by_value(module)


def _jax_lm():
    """The JAX small LM's numpy params, a seeded prompt and its greedy
    tokens from the JAX ``generate`` (in this process, no cluster)."""
    import importlib

    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtf
    jgen = importlib.import_module("ray_tpu.models.generate")
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **LM_CFG)
    jparams = jtf.transformer_init(jax.random.PRNGKey(1), jcfg)
    params = jax.tree.map(np.array, jparams)
    prompt = np.random.default_rng(5).integers(0, 97, (2, 9)).astype(
        np.int32)
    want = jgen.generate(jparams, jnp.asarray(prompt), jcfg,
                         max_new_tokens=12, temperature=0.0)
    return params, prompt, np.asarray(want)


def _port_run(params, prompt):
    import ray_tpu_torch
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.core import api

    def lm(rt):
        ref = rt.put(params)
        actor = rt.remote(LMActor).remote(ref, LM_CFG)
        tokens = rt.get(actor.generate.remote(prompt, 12), timeout=120)
        rt.kill(actor)
        return {"_lm_tokens": np.asarray(tokens)}

    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    prefixes = [n.store_prefix for n in c.nodes]
    try:
        ray_tpu_torch.init(address=c.address)
        try:
            out = _run_all("ray_tpu_torch", ray_tpu_torch, c, extra=lm)
        finally:
            ray_tpu_torch.shutdown()
    finally:
        c.shutdown()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and _segments(prefixes):
        time.sleep(0.05)
    out["_segments_left"] = _segments(prefixes)
    return out


def _segments(prefixes):
    return sorted(f for f in os.listdir("/dev/shm")
                  if any(f.startswith(p) for p in prefixes))


def _compute():
    params, prompt, want = _jax_lm()
    jax_out = _jax_run()            # the JAX cluster is down after this
    port_out = _port_run(params, prompt)
    return {"jax": jax_out, "port": port_out, "lm_want": want}


def _once(tmp_path_factory, name, compute):
    """``compute()`` once for the whole run, its result shared by the xdist
    workers through a pickle under the run's temporary root (a file lock
    lets one compute while the others wait)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            result = compute()
            with open(base / f"{name}.part", "wb") as f:
                pickle.dump(result, f)
            os.replace(base / f"{name}.part", path)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _once(tmp_path_factory, "torch_cluster_parity", _compute)


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_program_gives_the_jax_cluster_result(runs, program):
    want, got = runs["jax"][program], runs["port"][program]
    assert want[0] == "value", f"the JAX cluster raised: {want}"
    assert got == want


def test_bf16_comes_back_as_a_host_bf16_value(runs):
    """The JAX cluster returns an ml_dtypes bf16 numpy array, the port a
    bf16 CPU tensor: same dtype name, shape and values."""
    dtype, shape, _ = runs["port"]["bf16_tensor"][1]
    assert (dtype, shape) == ("bfloat16", (4, 6))


def test_worker_lm_generates_the_jax_tokens(runs):
    got = runs["port"]["_lm_tokens"]
    assert got.shape == runs["lm_want"].shape == (2, 12)
    np.testing.assert_array_equal(got, runs["lm_want"])


def test_port_run_left_no_segment(runs):
    assert runs["port"]["_segments_left"] == []
