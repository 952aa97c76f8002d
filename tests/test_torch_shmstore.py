"""The port's shmstore daemon and RPC layer, held to the JAX package's
tests of the same.

The first twelve tests are ``tests/test_shmstore.py``'s, run against the
port's own ``shmstored`` (built from ``ray_tpu_torch/cluster/native/
shmstore.cc`` into ``build/ray_tpu_torch/``): create/seal/get/release/
delete, blocking get, eviction + spill/restore, zero-copy numpy views. The
last three are ``tests/test_protocol.py``'s, against
``ray_tpu_torch.cluster.protocol``. Same inputs, same assertions.
"""

import os
import threading
import time

import numpy as np
import pytest

from ray_tpu_torch.cluster import object_client, protocol
from ray_tpu_torch.cluster.object_client import (ObjectStoreFullError,
                                                 ShmClient, start_store)
from ray_tpu_torch.cluster.protocol import RpcClient, RpcServer


@pytest.fixture
def store(tmp_path):
    sock = str(tmp_path / "store.sock")
    prefix = f"rtptst{os.getpid()}_"
    proc = start_store(sock, 64 << 20, prefix, str(tmp_path / "spill"))
    assert proc.args[0] == object_client._target()   # the port's own build
    client = ShmClient(sock, prefix)
    yield client, sock, prefix
    client.close()
    proc.kill()
    proc.wait()
    for f in os.listdir("/dev/shm"):
        if f.startswith(prefix):
            os.unlink(f"/dev/shm/{f}")


def oid(n: int) -> bytes:
    return n.to_bytes(16, "little")


def test_put_get_roundtrip(store):
    client, *_ = store
    data = np.arange(1000, dtype=np.float64)
    client.put(oid(1), data.tobytes())
    view = client.get(oid(1))
    out = np.frombuffer(view, dtype=np.float64)
    np.testing.assert_array_equal(out, data)
    client.release(oid(1))


def test_zero_copy_write_and_read(store):
    client, *_ = store
    buf = client.create(oid(2), 8 * 1024)
    arr = np.frombuffer(buf, dtype=np.float64)
    arr[:] = 42.0
    client.seal(oid(2))
    view = client.get(oid(2))
    assert np.frombuffer(view, dtype=np.float64)[123] == 42.0


def test_contains_and_delete(store):
    client, *_ = store
    assert not client.contains(oid(3))
    client.put(oid(3), b"hello")
    assert client.contains(oid(3))
    client.delete(oid(3))
    assert not client.contains(oid(3))


def test_blocking_get_wakes_on_seal(store):
    client, sock, prefix = store
    other = ShmClient(sock, prefix)
    result = {}

    def getter():
        result["view"] = other.get(oid(4), timeout=5.0)

    t = threading.Thread(target=getter)
    t.start()
    time.sleep(0.1)
    client.put(oid(4), b"late data")
    t.join(timeout=5)
    assert not t.is_alive()
    assert bytes(result["view"]) == b"late data"
    other.close()


def test_get_timeout(store):
    client, *_ = store
    t0 = time.monotonic()
    assert client.get(oid(5), timeout=0.2) is None
    assert 0.1 < time.monotonic() - t0 < 2.0


def test_oversize_rejected(store):
    client, *_ = store
    with pytest.raises(ObjectStoreFullError):
        client.create(oid(6), 1 << 40)


def test_eviction_spill_restore(store):
    client, *_ = store
    # fill past 64 MiB capacity with 8 MiB objects -> LRU spill to disk
    n = 12
    for i in range(n):
        data = np.full(1 << 20, i, dtype=np.float64)  # 8 MiB
        client.put(oid(100 + i), data.tobytes())
    stats = client.stats()
    assert stats["spills"] > 0
    # the earliest object was spilled; get() must transparently restore it
    view = client.get(oid(100))
    out = np.frombuffer(view, dtype=np.float64)
    assert out[0] == 0.0 and out[-1] == 0.0
    client.release(oid(100))
    assert client.stats()["restores"] >= 1


def test_stats(store):
    client, *_ = store
    client.put(oid(7), b"x" * 1000)
    s = client.stats()
    assert s["objects"] >= 1 and s["used"] >= 1000


# -- coordinated-spill ops: candidates, evict-with-report, accounting ------


def test_spill_candidates_coldest_first_with_cutoff(store):
    client, *_ = store
    sz = 1 << 20
    for i in range(4):
        client.put(oid(200 + i), b"a" * sz)
    # touch 200: a get bumps its LRU tick, so it is no longer coldest
    client.get(oid(200))
    client.release(oid(200))
    cands = client.spill_candidates(0)  # 0 = every candidate
    assert [c[1] for c in cands] == [sz] * 4
    assert cands[0][0] == oid(201), "coldest (untouched) must come first"
    assert cands[-1][0] == oid(200), "recently read must come last"
    # the byte cutoff stops at the first candidate reaching it
    assert len(client.spill_candidates(1)) == 1
    assert len(client.spill_candidates(sz + 1)) == 2
    # pinned objects are never candidates
    client.get(oid(201))
    assert oid(201) not in [c[0] for c in client.spill_candidates(0)]
    client.release(oid(201))


def test_evict_accounting_and_refusals(store):
    client, *_ = store
    sz = 1 << 20
    client.put(oid(210), b"b" * sz)
    # pinned by a reader: refused, copy stays
    client.get(oid(210))
    assert client.evict(oid(210)) is None
    assert client.contains(oid(210))
    client.release(oid(210))
    s0 = client.stats()
    assert client.evict(oid(210)) == sz
    assert not client.contains(oid(210))
    s1 = client.stats()
    assert s1["evictions"] == s0["evictions"] + 1
    # unsealed and unknown objects are refused too
    client.create(oid(211), 1024)
    assert client.evict(oid(211)) is None
    assert client.evict(oid(212)) is None


def test_spill_file_unlinked_on_delete(store, tmp_path):
    client, *_ = store
    sz = 8 << 20
    n = 12  # 96 MiB into a 64 MiB store -> LRU spill to disk
    for i in range(n):
        client.put(oid(300 + i), b"c" * sz)
    s0 = client.stats()
    assert s0["spills"] >= 1 and s0["spilled"] >= sz
    spill_dir = tmp_path / "spill"
    name = oid(300).hex()  # the coldest object was spilled first
    assert name in os.listdir(spill_dir)
    client.delete(oid(300))
    assert not client.contains(oid(300))
    s1 = client.stats()
    assert s1["spilled"] == s0["spilled"] - sz
    assert name not in os.listdir(spill_dir), \
        "deleting a spilled object must unlink its spill file"


def test_recycle_pool_reclaimed_before_spilling(store):
    client, *_ = store
    sz = 8 << 20
    client.put(oid(400), b"d" * sz)
    client.delete(oid(400))
    s0 = client.stats()
    assert s0["pool_bytes"] >= sz, "retired segment must enter the pool"
    # same-size create reuses the pooled segment instead of a fresh shm
    client.put(oid(401), b"e" * sz)
    s1 = client.stats()
    assert s1["recycles"] == s0["recycles"] + 1
    assert s1["pool_bytes"] == s0["pool_bytes"] - sz
    assert s1["spills"] == 0
    client.delete(oid(401))  # 8 MiB back in the pool
    # fill with sub-kRecycleMin objects (they can't use the pool) right
    # up to capacity: the overflow must be satisfied by reclaiming pool
    # pages FIRST — zero objects spilled or evicted
    small = 128 << 10
    n = (56 << 20) // small
    for i in range(n + 1):  # +1: one past capacity-minus-pool
        client.put(oid(500 + i), b"f" * small)
    s2 = client.stats()
    assert s2["pool_bytes"] == 0, "pressure must drain the pool first"
    assert s2["spills"] == 0 and s2["evictions"] == 0


# -- tests/test_protocol.py: pooled sockets, errors ---------------------


class _Svc:
    def __init__(self, tag):
        self.tag = tag

    def rpc_whoami(self):
        return self.tag

    def rpc_echo(self, x):
        return x


def test_store_binary_follows_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "shmstore.cc"
    src.write_text("// v1\n")
    monkeypatch.setattr(object_client, "_SRC", str(src))
    first = object_client._target()
    assert os.path.dirname(first) == object_client._BUILD_DIR
    assert os.path.basename(first).startswith("shmstored-")
    assert object_client._target() == first
    src.write_text("// v2\n")
    second = object_client._target()
    assert second != first
    monkeypatch.setattr(object_client, "CXX_FLAGS",
                        object_client.CXX_FLAGS + ["-g"])
    assert object_client._target() not in (first, second)


def test_pooled_socket_survives_server_replacement():
    s1 = RpcServer(_Svc("first"))
    cli = RpcClient(s1.address)
    assert cli.call("whoami") == "first"   # pools a keep-alive socket
    port = int(s1.address.rsplit(":", 1)[1])
    s1.stop()
    # New server, SAME port — the cached socket is now stale.
    s2 = RpcServer(_Svc("second"), port=port)
    try:
        assert cli.call("whoami") == "second"  # fresh-socket retry
    finally:
        s2.stop()
        cli.close()


def test_dead_server_still_raises():
    s = RpcServer(_Svc("x"))
    cli = RpcClient(s.address)
    assert cli.call("echo", x=5) == 5
    s.stop()
    with pytest.raises((protocol.ConnectionLost, ConnectionError, OSError)):
        cli.call("echo", x=6)   # nothing listening: fail, don't loop
    cli.close()


def test_error_propagation_and_unknown_method():
    class Boom:
        def rpc_kaboom(self):
            raise ValueError("inner detail")

    s = RpcServer(Boom())
    cli = RpcClient(s.address)
    try:
        with pytest.raises(ValueError, match="inner detail"):
            cli.call("kaboom")
        with pytest.raises(protocol.RpcError, match="no such method"):
            cli.call("nope")
    finally:
        s.stop()
        cli.close()


# -- the two packages' stale-segment sweeps keep to their own prefixes ---


def _fake_group(prefix, owner_pid):
    names = [prefix + "owner", prefix + "0001", prefix + "0002"]
    for n in names:
        with open(f"/dev/shm/{n}", "w") as f:
            f.write(f"{owner_pid}\n" if n.endswith("owner") else "x")
    return names


def _dead_pid():
    import subprocess
    p = subprocess.Popen(["true"])
    p.wait()
    return p.pid


def test_neither_sweep_touches_the_other_packages_segments():
    """``rtpt-`` (the port) and ``rtpu-`` (the JAX package) groups, dead
    and live: each package's sweep reclaims only its own dead group, so the
    two can run at once on one host."""
    from ray_tpu.cluster import hygiene as jax_hygiene
    from ray_tpu_torch.cluster import hygiene as port_hygiene
    tag = f"{os.getpid() & 0xffffff:06x}"
    dead = _dead_pid()
    groups = {
        "port_dead": _fake_group(f"rtpt-{tag}a1-", dead),
        "port_live": _fake_group(f"rtpt-{tag}a2-", os.getpid()),
        "jax_dead": _fake_group(f"rtpu-{tag}b1-", dead),
        "jax_live": _fake_group(f"rtpu-{tag}b2-", os.getpid()),
    }

    def present(key):
        return [n for n in groups[key] if os.path.exists(f"/dev/shm/{n}")]

    # Judged by what each sweep reports it removed: other test processes
    # may run either package's sweep at the same time.
    try:
        removed = port_hygiene.sweep_shm()
        assert not [n for n in removed if n.startswith("rtpu-")], removed
        assert present("port_dead") == []
        jax_removed = jax_hygiene.sweep_shm()
        assert not [n for n in jax_removed if n.startswith("rtpt-")], \
            jax_removed
        assert present("jax_dead") == []
        for key in ("port_live", "jax_live"):
            assert present(key) == groups[key], key
    finally:
        for names in groups.values():
            for n in names:
                try:
                    os.unlink(f"/dev/shm/{n}")
                except OSError:
                    pass
