"""Storage URIs in the port: the syncer's backends (``tune/syncer.py``),
``workflow/storage.py``'s ``UriStorage``, and spilling to a URI root
(``cluster/spill.py``), held to the JAX package's modules where both run.

- ``parse_uri``/``is_uri`` equal the JAX ones; each backend round-trips a
  tree (``mock://``, a directory and, with fsspec, ``file://``).
- ``UriStorage`` on ``mock://`` and ``file://``: put, get, exists, list and
  delete, with the same ``mock://`` tree as the JAX ``UriStorage``.
- ``SpillBackend`` on a ``mock://`` root writes the same URLs and bytes as
  the JAX ``SpillBackend``; a root that is a URI no longer raises, and a
  port ``Cluster`` whose spill root is a ``file://`` URI spills objects
  there and restores them bit for bit.

This module imports JAX only inside functions: the cluster's workers may
import it by name.
"""

import os
import time

import numpy as np
import pytest

from ray_tpu_torch.cluster import spill
from ray_tpu_torch.tune import syncer
from ray_tpu_torch.workflow import storage as wf_storage

URIS = ["", "/tmp/x", "relative/dir", "C:\\data", "mock://bucket/a",
        "file:///tmp/y", "gs://b/k", "s3://b/k/", "memory://m"]


@pytest.mark.parametrize("uri", URIS)
def test_parse_uri_equals_the_jax_syncer(uri):
    from ray_tpu.tune import syncer as jax_syncer
    assert syncer.parse_uri(uri) == jax_syncer.parse_uri(uri)
    assert syncer.is_uri(uri) == jax_syncer.is_uri(uri)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _write_tree(root):
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    with open(os.path.join(root, "a.bin"), "wb") as f:
        f.write(b"\x00\x01alpha")
    with open(os.path.join(root, "sub", "b.txt"), "wb") as f:
        f.write(b"beta")
    return _tree(root)


@pytest.mark.parametrize("scheme", ["dir", "mock", "file"])
def test_syncer_backends_round_trip_a_tree(tmp_path, scheme):
    if scheme == "file":
        pytest.importorskip("fsspec")
    want = _write_tree(str(tmp_path / "src"))
    uri = {"dir": str(tmp_path / "remote"),
           "mock": f"mock://bucket/{tmp_path.name}",
           "file": f"file://{tmp_path}/remote"}[scheme]
    s = syncer.Syncer(uri)
    assert not s.exists()
    s.sync_up(str(tmp_path / "src"))
    assert s.exists()
    s.sync_down(str(tmp_path / "back"))
    assert _tree(str(tmp_path / "back")) == want


def test_local_cache_dir_is_per_uri_under_the_temporary_directory():
    import tempfile
    a = syncer.local_cache_dir("mock://bucket/a")
    assert a == syncer.local_cache_dir("mock://bucket/a")
    assert a != syncer.local_cache_dir("mock://bucket/b")
    assert a.startswith(os.path.join(tempfile.gettempdir(),
                                     "rtpt-storage-cache"))
    assert os.path.isdir(a)


def _storage_ops(st):
    st.put_bytes("wf1/steps/0000_a.pkl", b"one")
    st.put_bytes("wf1/status", b"RUNNING")
    st.put_bytes("wf2/status", b"FAILED")
    out = {"get": st.get_bytes("wf1/steps/0000_a.pkl"),
           "exists": (st.exists("wf1/status"), st.exists("wf3/status")),
           "top": st.list_prefix(""), "wf1": st.list_prefix("wf1"),
           "missing": st.list_prefix("nope")}
    st.delete_prefix("wf1")
    out["after_delete"] = (st.exists("wf1/status"), st.list_prefix(""))
    return out


WANT_OPS = {"get": b"one", "exists": (True, False), "top": ["wf1", "wf2"],
            "wf1": ["status", "steps"], "missing": [],
            "after_delete": (False, ["wf2"])}


def test_uri_storage_on_mock_equals_the_jax_uri_storage():
    from ray_tpu.tune.syncer import _MockBackend as JaxMock
    from ray_tpu.workflow import storage as jax_storage
    root = "mock://bucket/uri-storage-parity"
    jax_out = _storage_ops(jax_storage.storage_for(root))
    port_out = _storage_ops(wf_storage.storage_for(root))
    assert port_out == jax_out == WANT_OPS
    assert isinstance(wf_storage.storage_for(root), wf_storage.UriStorage)
    port_tree = {k: v for k, v in syncer._MockBackend.store.items()
                 if k.startswith(root)}
    jax_tree = {k: v for k, v in JaxMock.store.items() if k.startswith(root)}
    assert port_tree == jax_tree and port_tree


def test_uri_storage_on_file_uri(tmp_path):
    pytest.importorskip("fsspec")
    st = wf_storage.storage_for(f"file://{tmp_path}/wf")
    assert isinstance(st, wf_storage.UriStorage)
    assert _storage_ops(st) == WANT_OPS
    assert (tmp_path / "wf" / "wf2" / "status" / "blob").read_bytes() == \
        b"FAILED"


def test_file_storage_is_a_directory(tmp_path):
    st = wf_storage.storage_for(str(tmp_path / "wf"))
    assert isinstance(st, wf_storage.FileStorage)
    assert _storage_ops(st) == WANT_OPS


OIDS = [bytes([i]) * 28 for i in (1, 2, 3)]


def _spill_ops(spill_mod, root):
    b = spill_mod.SpillBackend(root)
    urls = [b.write(oid, memoryview(oid + b"-payload" * (i + 1)))
            for i, oid in enumerate(OIDS)]
    out = {"urls": urls,
           "read": [b.read(oid) for oid in OIDS],
           "read_url": [spill_mod.read_url(u) for u in urls],
           "exists": [b.exists(oid) for oid in OIDS],
           "local_path": [spill_mod.local_path(u) for u in urls],
           "split": [spill_mod.split_url(u) for u in urls]}
    b.delete(OIDS[0])
    spill_mod.delete_url(urls[1])
    spill_mod.delete_url(urls[1])      # a second delete is fine
    out["after_delete"] = [b.exists(oid) for oid in OIDS]
    return out


def test_spill_to_mock_uri_equals_the_jax_spill_backend():
    from ray_tpu.cluster import spill as jax_spill
    from ray_tpu.tune.syncer import _MockBackend as JaxMock
    root = "mock://bucket/spill-parity"
    jax_out = _spill_ops(jax_spill, root)
    port_out = _spill_ops(spill, root)
    assert port_out == jax_out
    assert port_out["urls"] == [f"{root}/{oid.hex()}" for oid in OIDS]
    assert port_out["local_path"] == [None] * 3
    assert port_out["after_delete"] == [False, False, True]
    port_tree = {k: v for k, v in syncer._MockBackend.store.items()
                 if k.startswith(root)}
    jax_tree = {k: v for k, v in JaxMock.store.items() if k.startswith(root)}
    assert port_tree == jax_tree == {
        f"{root}/{OIDS[2].hex()}": {"blob": OIDS[2] + b"-payload" * 3}}


def test_spill_to_a_directory_is_unchanged(tmp_path):
    from ray_tpu.cluster import spill as jax_spill
    out = _spill_ops(spill, str(tmp_path / "port"))
    ref = _spill_ops(jax_spill, str(tmp_path / "jax"))
    assert out["read"] == ref["read"] and out["exists"] == ref["exists"]
    assert out["local_path"] == [str(tmp_path / "port" / oid.hex())
                                 for oid in OIDS]
    assert out["after_delete"] == ref["after_delete"] == [False, False, True]
    assert sorted(os.listdir(tmp_path / "port")) == [OIDS[2].hex()]


@pytest.mark.parametrize("root", ["mock://bucket/ctor", "file:///tmp/ctor",
                                  "s3://bucket/spill"])
def test_a_spill_root_that_is_a_uri_no_longer_raises(root):
    b = spill.SpillBackend(root)
    assert b.url_for(OIDS[0]) == f"{root}/{OIDS[0].hex()}"
    assert spill.local_path(b.url_for(OIDS[0])) is None


def test_cluster_spills_to_a_file_uri_and_restores(tmp_path):
    """A port cluster whose spill root is a ``file://`` URI: puts past the
    store's capacity spill through fsspec, and each object comes back bit
    for bit."""
    pytest.importorskip("fsspec")
    import ray_tpu_torch as rt
    from ray_tpu_torch import config
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    root = tmp_path / "spilled"
    config.set_override("object_store_spill_threshold", 0.4)
    config.set_override("object_spill_dir", f"file://{root}")
    rt.shutdown()
    c = Cluster(initialize_head=True, head_node_args={
        "num_cpus": 1, "num_gpus": 0, "object_store_bytes": 16 << 20})
    try:
        rt.init(address=c.address)
        arrays = [np.full(1 << 20, i, dtype=np.float32) for i in range(8)]
        refs = [rt.put(a) for a in arrays]      # 32 MB into a 16 MB store
        deadline = time.time() + 30
        while not (root.exists() and os.listdir(root)) \
                and time.time() < deadline:
            time.sleep(0.2)
        assert root.exists() and os.listdir(root)
        for ref, want in zip(refs, arrays):
            got = rt.get(ref, timeout=60)
            assert np.array_equal(got, want)
            del got
    finally:
        rt.shutdown()
        c.shutdown()
        config.clear_override("object_store_spill_threshold")
        config.clear_override("object_spill_dir")
