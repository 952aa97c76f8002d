"""The pools and the queue of the port's ``util/``, held to the JAX
package's on the same inputs.

- ``multiprocessing.Pool`` (``map``, ``imap``, ``starmap``, ``apply_async``
  with ``kwds``), ``ActorPool`` and ``Queue`` on a port ``Cluster``, against
  the JAX ones on the JAX in-process runtime (JAX:
  ``tests/test_dag_workflow_util.py:144``, ``:156``, ``:169``).
- The joblib round trip on the port's in-process runtime, as the JAX test
  runs it (``tests/test_gcp_joblib.py:145``), and on a port ``Cluster``.

Functions are module-level: the port's cluster ships them by import path
(the JAX test's lambdas would raise ``TypeError`` there), and its workers
import this module by name, so it imports JAX only inside functions.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster.cluster_utils import Cluster


def square(x):
    return x * x


def plus(a, b):
    return a + b


def affine(a, x=0, scale=1):
    return a * scale + x


def boom(i):
    raise ValueError("joblib-boom")


class Sq:
    def f(self, x):
        return x * x


def _pool_results(pkg):
    """The JAX test's pool calls, with module-level functions, through
    ``pkg``'s pool (its runtime already started)."""
    import importlib
    Pool = importlib.import_module(f"{pkg}.util.multiprocessing").Pool
    with Pool(processes=3) as pool:
        return {
            "map": pool.map(square, range(10)),
            "map_chunked": pool.map(square, range(23), chunksize=4),
            "starmap": pool.starmap(plus, [(1, 2), (3, 4)]),
            "apply_async": pool.apply_async(plus, (41, 1)).get(timeout=60),
            "apply_async_kwds": pool.apply_async(
                affine, (5,), {"x": 2, "scale": 3}).get(timeout=60),
            "apply": pool.apply(affine, (7,), {"scale": 2}),
            "imap": list(pool.imap(str, [1, 2, 3])),
            "map_async": pool.map_async(square, [4, 5]).get(timeout=60),
        }


def _actor_pool_results(pkg):
    import importlib
    mod = importlib.import_module(pkg)
    ActorPool = importlib.import_module(f"{pkg}.util").ActorPool
    cls = mod.remote(Sq)
    ordered = list(ActorPool([cls.remote() for _ in range(2)]).map(
        _call_f, [1, 2, 3, 4]))
    unordered = sorted(ActorPool([cls.remote() for _ in range(3)])
                       .map_unordered(_call_f, range(7)))
    return {"map": ordered, "map_unordered": unordered}


def _call_f(actor, v):
    return actor.f.remote(v)


def _queue_results(pkg):
    import importlib
    util = importlib.import_module(f"{pkg}.util")
    Empty = importlib.import_module(f"{pkg}.util.queue").Empty
    Full = importlib.import_module(f"{pkg}.util.queue").Full
    q = util.Queue(maxsize=2)
    q.put("a")
    q.put("b")
    out = {"qsize": q.qsize(), "full": q.full()}
    try:
        q.put_nowait("c")
        out["put_full"] = "put"
    except Full:
        out["put_full"] = "Full"
    out["got"] = [q.get(), q.get()]
    out["empty"] = q.empty()
    try:
        q.get(block=False)
        out["get_empty"] = "got"
    except Empty:
        out["get_empty"] = "Empty"
    try:
        q.get(timeout=0.2)
        out["get_timeout"] = "got"
    except Empty:
        out["get_timeout"] = "Empty"
    q.shutdown()
    return out


@pytest.fixture(scope="module")
def jax_results():
    import ray_tpu
    ray_tpu.shutdown()
    ray_tpu.init(local_mode=True, num_cpus=8)
    try:
        return {"pool": _pool_results("ray_tpu"),
                "actor_pool": _actor_pool_results("ray_tpu"),
                "queue": _queue_results("ray_tpu")}
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 8,
                                                      "num_gpus": 0})
    ray_tpu_torch.init(address=c.address)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()


def test_multiprocessing_pool_equals_the_jax_pool(jax_results, cluster):
    got = _pool_results("ray_tpu_torch")
    assert got == jax_results["pool"]
    assert got["map"] == [x * x for x in range(10)]
    assert got["apply_async_kwds"] == 17 and got["imap"] == ["1", "2", "3"]


def test_pool_lambda_raises_type_error_on_the_cluster(cluster):
    from ray_tpu_torch.util.multiprocessing import Pool
    with Pool(processes=1) as pool:
        with pytest.raises(TypeError, match="define it at module level"):
            pool.map(lambda x: x, [1])
        pool.close()
        with pytest.raises(ValueError, match="closed"):
            pool.map(square, [1])
        pool.join()


def test_actor_pool_equals_the_jax_actor_pool(jax_results, cluster):
    got = _actor_pool_results("ray_tpu_torch")
    assert got == jax_results["actor_pool"]
    assert got["map"] == [1, 4, 9, 16]


def test_distributed_queue_equals_the_jax_queue(jax_results, cluster):
    got = _queue_results("ray_tpu_torch")
    assert got == jax_results["queue"]
    assert got["got"] == ["a", "b"] and got["get_empty"] == "Empty"


def _joblib_round_trip(n_jobs):
    import joblib
    from joblib import Parallel, delayed

    from ray_tpu_torch.util.joblib_backend import register_ray_tpu_torch
    register_ray_tpu_torch()
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=n_jobs):
        out = Parallel()(delayed(square)(i) for i in range(20))
    assert out == [i * i for i in range(20)]
    with pytest.raises(ValueError, match="joblib-boom"):
        with joblib.parallel_backend("ray_tpu_torch", n_jobs=2):
            Parallel()(delayed(boom)(i) for i in range(2))


def test_joblib_backend_roundtrip_in_process():
    pytest.importorskip("joblib")
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        _joblib_round_trip(4)
    finally:
        ray_tpu_torch.shutdown()


def test_joblib_backend_roundtrip_on_the_cluster(cluster):
    """On the cluster runtime each batch ships by import path, its joblib
    backend included (a module attribute of ``joblib_backend``)."""
    pytest.importorskip("joblib")
    _joblib_round_trip(4)


def test_both_joblib_backends_register_in_one_process():
    joblib = pytest.importorskip("joblib")
    from ray_tpu.util.joblib_backend import register_ray_tpu

    from ray_tpu_torch.util.joblib_backend import (RayTpuTorchBackend,
                                                   register_ray_tpu_torch)
    register_ray_tpu()
    register_ray_tpu_torch()
    backends = joblib.parallel.BACKENDS
    assert backends["ray_tpu_torch"] is RayTpuTorchBackend
    assert backends["ray_tpu"] is not RayTpuTorchBackend
