"""The port's GCE GPU-VM provider (``ray_tpu_torch/autoscaler/gce.py``) with
a fake transport, and the launcher's ``gce_gpu`` provider type.

- *Ported tests:* ``tests/test_gcp_joblib.py``'s three provider tests
  (scale up and down through the autoscaler, a multi-host unit deleted only
  when every host is idle and exactly once, clusters isolated by label). A
  JAX node type is a TPU slice (``v5litepod-8``); the port's is an NVLink
  domain (``h100-8``) on a machine type (``a3-highgpu-8g``), and one
  provider node is every VM of one domain.
- *The port's own:* the ``gcloud`` command lines the transport builds (a
  fake runner records them; nothing reaches the network), the startup
  script that hands each host its domain, ``node_id_map``'s join on the
  domain name that the daemons report, and the launcher's spec checks.
"""

import json

import pytest

from ray_tpu_torch import cluster_launcher
from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.gce import GceGpuApi, GceGpuNodeProvider
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.cluster.protocol import get_client
from ray_tpu_torch.gpu import topology


class FakeGceApi:
    """Records GCE API calls; returns RUNNING instances for list()."""

    def __init__(self):
        self.nodes = {}
        self.calls = []

    def create(self, name, machine_type, startup_script, labels, **kw):
        self.calls.append(("create", name, machine_type))
        assert "-m ray_tpu_torch start" in startup_script
        self.nodes[name] = {"name": name, "status": "RUNNING",
                            "labels": dict(labels),
                            "machineType": machine_type,
                            "script": startup_script}

    def delete(self, name):
        self.calls.append(("delete", name))
        if name not in self.nodes:
            raise RuntimeError("NOT_FOUND")  # gcloud exits nonzero
        del self.nodes[name]

    def list(self, label_filter):
        return [n for n in self.nodes.values()
                if all(n["labels"].get(k) == v
                       for k, v in label_filter.items())]


H100_8 = {"accelerator_type": "h100-8", "machine_type": "a3-highgpu-8g",
          "resources": {"CPU": 8.0, "GPU": 8.0}, "max_workers": 2}


def test_gce_provider_scale_up_down():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    try:
        api = FakeGceApi()
        types = {"h100-8": H100_8}
        provider = GceGpuNodeProvider(c.address, types,
                                      cluster_name="t1", api=api)
        # Direct provider surface
        name = provider.create_node("h100-8")
        assert name.startswith("rtpt-t1-h100-8-")
        assert api.calls[0] == ("create", f"{name}-0", "a3-highgpu-8g")
        assert provider.non_terminated_nodes() == [(name, "h100-8")]

        # Through the autoscaler reconcile loop: pending GPU demand
        # launches a domain of the right type, capped at max_workers.
        auto = StandardAutoscaler(c.address, provider, types,
                                  max_workers=4)
        # Demand reaches the conductor via daemon heartbeats; report it
        # from the (registered) head node like node_daemon does.
        cli = get_client(c.address)
        head = cli.call("get_nodes")[0]
        cli.call("heartbeat", node_id=head["node_id"],
                 resources_available=head["resources_available"],
                 pending_demand=[{"GPU": 8.0}] * 5)
        launched = auto.update()
        assert launched.get("h100-8", 0) >= 1
        total = len(provider.non_terminated_nodes())
        assert total <= 2  # max_workers cap for the type

        provider.terminate_node(name)
        assert name not in dict(provider.non_terminated_nodes())
    finally:
        c.shutdown()


def test_scale_down_waits_for_whole_domain():
    """A two-host domain (two node_ids -> one provider id) is deleted only
    when EVERY host is idle past the timeout, all its VMs exactly once."""
    api = FakeGceApi()
    types = {"h100-16": {"accelerator_type": "h100-16",
                         "machine_type": "a3-highgpu-8g",
                         "resources": {"GPU": 8.0}}}
    provider = GceGpuNodeProvider("127.0.0.1:1", types, cluster_name="s",
                                  api=api)
    name = provider.create_node("h100-16")
    assert sorted(api.nodes) == [f"{name}-0", f"{name}-1"]
    auto = StandardAutoscaler("127.0.0.1:1", provider, types,
                              idle_timeout_s=0.0)
    provider.node_id_map = lambda: {b"h0": name, b"h1": name}

    def node(nid, idle):
        avail = {"GPU": 8.0} if idle else {"GPU": 0.0}
        return {"node_id": nid, "is_head": False,
                "resources_available": avail,
                "resources_total": {"GPU": 8.0}}

    class StubConductor:
        def __init__(self):
            self.nodes = [node(b"h0", True), node(b"h1", False)]

        def call(self, method, **kw):
            assert method == "cluster_load"
            return {"demand": [], "nodes": self.nodes}

    stub = auto.conductor = StubConductor()
    auto.update()   # h0 idle, h1 busy -> domain must survive
    auto.update()
    assert name in dict(provider.non_terminated_nodes())

    stub.nodes = [node(b"h0", True), node(b"h1", True)]
    auto.update()   # mark idle
    auto.update()   # now past (zero) timeout on both -> delete once
    assert name not in dict(provider.non_terminated_nodes())
    deletes = [c for c in api.calls if c[0] == "delete"]
    assert sorted(deletes) == [("delete", f"{name}-0"),
                               ("delete", f"{name}-1")]
    # idempotent terminate: deleting again must not raise
    provider.terminate_node(name)


def test_gce_provider_isolated_by_cluster():
    api = FakeGceApi()
    types = {"a": {"accelerator_type": "h100-8",
                   "machine_type": "a3-highgpu-8g", "resources": {}}}
    p1 = GceGpuNodeProvider("127.0.0.1:1", types, cluster_name="one",
                            api=api)
    p2 = GceGpuNodeProvider("127.0.0.1:1", types, cluster_name="two",
                            api=api)
    n1 = p1.create_node("a")
    p2.create_node("a")
    assert len(p1.non_terminated_nodes()) == 1
    assert p1.non_terminated_nodes()[0][0] == n1


def test_startup_script_hands_each_host_its_domain():
    """Each host's script exports the domain's name, its index and the type
    that ``detect_domain`` reads, then starts a daemon against the head."""
    api = FakeGceApi()
    types = {"gb": {"accelerator_type": "gb200-8",
                    "machine_type": "a4x-highgpu-4g", "resources": {}}}
    provider = GceGpuNodeProvider("10.0.0.2:6380", types, cluster_name="x",
                                  api=api)
    name = provider.create_node("gb")          # 2 hosts of 4 cards
    for w in range(2):
        script = api.nodes[f"{name}-{w}"]["script"]
        assert f"export {topology.ENV_DOMAIN}={name}\n" in script
        assert f"export {topology.ENV_WORKER_ID}={w}\n" in script
        assert f"export {topology.ENV_TYPE}=gb200-8\n" in script
        assert script.rstrip().endswith(
            "-m ray_tpu_torch start --address=10.0.0.2:6380 --block")
        env = dict(line[len("export "):].split("=", 1)
                   for line in script.splitlines()
                   if line.startswith("export "))
        dom = topology.domain_from_probe(["NVIDIA GB200"] * 4, "", "", env)
        assert (dom["slice_id"], dom["domain_name"], dom["worker_id"],
                dom["accelerator_type"], dom["num_hosts"],
                dom["gpus_per_host"]) == (name, name, w, "gb200-8", 2, 4)


def test_long_names_keep_each_domain_its_own():
    """A long cluster name and node type are cut, not the domain's uuid:
    two domains of one type keep distinct names, every VM name fits GCE's
    63 characters, and scaling one domain down leaves the other's VMs."""
    import re
    api = FakeGceApi()
    node_type = "hgx-h100-eight-card-training-pool-with-a-long-name"
    types = {node_type: {"accelerator_type": "gb200-72",   # 18 hosts
                         "machine_type": "a4x-highgpu-4g", "resources": {}}}
    provider = GceGpuNodeProvider(
        "10.0.0.2:6380", types, api=api,
        cluster_name="research-cluster-of-the-language-modelling-team")
    first = provider.create_node(node_type)
    second = provider.create_node(node_type)
    assert first != second
    assert len(api.nodes) == 36
    for name in api.nodes:
        assert re.fullmatch(r"[a-z]([-a-z0-9]{0,61}[a-z0-9])?", name), name
    assert {n for n, _ in provider.non_terminated_nodes()} == {first, second}
    provider.terminate_node(first)
    assert sorted(api.nodes) == sorted(f"{second}-{w}" for w in range(18))


def test_gcloud_command_lines():
    calls = []

    def runner(argv):
        calls.append(argv)
        return "[]" if argv[3] == "list" else ""

    api = GceGpuApi("proj", "us-central1-a", runner=runner)
    api.create("vm-0", "a3-highgpu-8g", "#!/bin/bash\n",
               {"a": "b", "c": "d"}, image_family="fam", image_project="imgs")
    api.delete("vm-0")
    assert api.list({"a": "b", "c": "d"}) == []
    tail = ["--project=proj", "--zone=us-central1-a", "--format=json"]
    assert calls == [
        ["gcloud", "compute", "instances", "create", "vm-0",
         "--machine-type=a3-highgpu-8g", "--maintenance-policy=TERMINATE",
         "--labels=a=b,c=d", "--metadata=startup-script=#!/bin/bash\n",
         "--image-family=fam", "--image-project=imgs", *tail],
        ["gcloud", "compute", "instances", "delete", "vm-0", "--quiet",
         *tail],
        ["gcloud", "compute", "instances", "list",
         "--filter=labels.a=b AND labels.c=d", *tail]]


def test_node_id_map_joins_on_the_reported_domain_name():
    api = FakeGceApi()
    types = {"h100-8": H100_8}
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    try:
        provider = GceGpuNodeProvider(c.address, types, cluster_name="j",
                                      api=api)
        name = provider.create_node("h100-8")
        # what the VM's daemon reports once its startup script ran
        node = c.add_node(num_cpus=1, num_gpus=8, gpu_domain=dict(
            topology.domain_from_probe(
                ["NVIDIA H100 80GB HBM3"] * 8, "", "",
                {topology.ENV_DOMAIN: name, topology.ENV_TYPE: "h100-8"})))
        other = topology.domain_from_probe(["NVIDIA H100 80GB HBM3"] * 8, "",
                                           "", {})     # not the provider's
        c.add_node(num_cpus=1, num_gpus=8, gpu_domain=other)
        c.wait_for_nodes(3)
        assert provider.node_id_map() == {node.node_id: name}
    finally:
        c.shutdown()


def test_launcher_accepts_gce_gpu_and_names_it_for_gcp_tpu(tmp_path):
    spec = {"cluster_name": "g",
            "provider": {"type": "gce_gpu", "project": "p", "zone": "z"},
            "node_types": {"gpu": {"accelerator_type": "h100-8",
                                   "machine_type": "a3-highgpu-8g",
                                   "resources": {"CPU": 8, "GPU": 8}}}}
    path = tmp_path / "gce.json"
    path.write_text(json.dumps(spec))
    cfg = cluster_launcher.load_config(str(path))
    provider = cluster_launcher._build_provider(cfg, "127.0.0.1:1")
    assert isinstance(provider, GceGpuNodeProvider)
    assert (provider.api.project, provider.api.zone) == ("p", "z")
    bad = dict(spec, node_types={"gpu": {"accelerator_type": "v4-8",
                                         "machine_type": "m"}})
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="Bad accelerator type"):
        cluster_launcher.load_config(str(path))
    bad = dict(spec, node_types={"gpu": {"accelerator_type": "h100-8"}})
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="machine_type"):
        cluster_launcher.load_config(str(path))
    path.write_text(json.dumps({"cluster_name": "g",
                                "provider": {"type": "gcp_tpu"}}))
    with pytest.raises(NotImplementedError, match="gce_gpu"):
        cluster_launcher.load_config(str(path))
