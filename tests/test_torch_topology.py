"""The NVLink-domain model of ``ray_tpu_torch/gpu/topology.py``: the GPU
counterpart of the JAX package's TPU-slice model (``ray_tpu/tpu/topology.py``:
``SliceSpec``, ``detect_slice``, ``tpu_resources``).

``detect_domain``'s parsing is pure functions of ``nvidia-smi``'s text, fed
here with outputs written into the test: an 8-card HGX H100 board (every
pair joined by NV18), two PCIe H100 cards with no NVLink, and one card; and
``nvidia-smi -q``'s Fabric block of a multi-node NVLink host and of an HGX
board whose NVSwitches serve only itself.
"""

import hashlib

import pytest

from ray_tpu_torch.gpu import topology
from ray_tpu_torch.gpu.topology import DomainSpec

_HGX_ROW = "NV18    " * 7


def _hgx_text():
    header = ("\x1b[4m\tGPU0\tGPU1\tGPU2\tGPU3\tGPU4\tGPU5\tGPU6\tGPU7\t"
              "NIC0\tNIC1\tCPU Affinity\tNUMA Affinity\tGPU NUMA ID\x1b[0m")
    rows = []
    for i in range(8):
        links = ["NV18"] * 8
        links[i] = " X "
        cpus = "0-55,112-167\t0" if i < 4 else "56-111,168-223\t1"
        rows.append(f"GPU{i}\t" + "\t".join(links) +
                    f"\tPIX\tNODE\t{cpus}\t\tN/A")
    nics = ["NIC0\tPIX\tPIX\tNODE\tNODE\tSYS\tSYS\tSYS\tSYS\t X \tNODE",
            "NIC1\tNODE\tNODE\tPIX\tPIX\tSYS\tSYS\tSYS\tSYS\tNODE\t X "]
    legend = """
Legend:

  X    = Self
  SYS  = Connection traversing PCIe as well as the SMP interconnect between NUMA nodes (e.g., QPI/UPI)
  NODE = Connection traversing PCIe as well as the interconnect between PCIe Host Bridges within a NUMA node
  PHB  = Connection traversing PCIe as well as a PCIe Host Bridge (typically the CPU)
  PXB  = Connection traversing multiple PCIe bridges (without traversing the PCIe Host Bridge)
  PIX  = Connection traversing at most a single PCIe bridge
  NV#  = Connection traversing a bonded set of # NVLinks

NIC Legend:

  NIC0: mlx5_0
  NIC1: mlx5_1
"""
    return "\n".join([header, *rows, *nics]) + "\n" + legend


HGX_8 = _hgx_text()

PCIE_2 = """\
        GPU0    GPU1    CPU Affinity    NUMA Affinity   GPU NUMA ID
GPU0     X      SYS     0-15            0               N/A
GPU1    SYS      X      16-31           1               N/A

Legend:

  X    = Self
  SYS  = Connection traversing PCIe as well as the SMP interconnect between NUMA nodes (e.g., QPI/UPI)
  NV#  = Connection traversing a bonded set of # NVLinks
"""

ONE_CARD = """\
        GPU0    CPU Affinity    NUMA Affinity   GPU NUMA ID
GPU0     X      0-25            0               N/A

Legend:

  X    = Self
"""

FABRIC_NVL = """\
==============NVSMI LOG==============

Attached GPUs                             : 4
GPU 00000008:01:00.0
    Product Name                          : NVIDIA GB200
    Fabric
        State                             : Completed
        Status                            : Success
        CliqueId                          : 32766
        ClusterUUID                       : 2b5fb2e5-3fb2-4b3d-a8b2-1c5f9b5a7e10
        Health
            Bandwidth                     : Full
    Processes                             : None
"""

FABRIC_HGX = """\
GPU 00000000:18:00.0
    Product Name                          : NVIDIA H100 80GB HBM3
    Fabric
        State                             : Completed
        Status                            : Success
        CliqueId                          : 0
        ClusterUUID                       : 00000000-0000-0000-0000-000000000000
"""


UUIDS_A = [f"GPU-0a1b2c3d-0000-4000-8000-00000000000{i}" for i in range(8)]
UUIDS_B = [f"GPU-7f6e5d4c-0000-4000-8000-00000000000{i}" for i in range(8)]


def _digest(keys):
    return hashlib.sha1(",".join(keys).encode()).hexdigest()[:12]


@pytest.mark.parametrize("name,want", [
    ("h100-8", ("h100", 8, 8, 1)), ("h100-16", ("h100", 16, 8, 2)),
    ("h100-1", ("h100", 1, 1, 1)), ("a100-8", ("a100", 8, 8, 1)),
    ("h200-8", ("h200", 8, 8, 1)), ("b200-8", ("b200", 8, 8, 1)),
    ("gb200-72", ("gb200", 72, 4, 18)), ("gb200-4", ("gb200", 4, 4, 1))])
def test_domain_spec_parse(name, want):
    spec = DomainSpec.parse(name)
    assert (spec.generation, spec.num_gpus, spec.gpus_per_host,
            spec.num_hosts) == want
    assert spec.accelerator_type == name


@pytest.mark.parametrize("name", ["v4-8", "h100", "h100-0", "H100-8",
                                  "h100-8x", "x100-8", "-8", ""])
def test_domain_spec_parse_refuses_bad_names(name):
    with pytest.raises(ValueError, match="Bad accelerator type"):
        DomainSpec.parse(name)


@pytest.mark.parametrize("name,gen", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100"),
    ("NVIDIA H200", "h200"), ("NVIDIA A100-SXM4-80GB", "a100"),
    ("NVIDIA B200", "b200"), ("NVIDIA GB200", "gb200"),
    ("NVIDIA GH200 480GB", "gh200"), ("NVIDIA L40S", "l40"),
    ("Some Card", "")])
def test_generation_from_name(name, gen):
    assert topology.generation_from_name(name) == gen


def test_topo_matrix_of_an_hgx_board():
    m = topology.parse_topo_matrix(HGX_8)
    assert sorted(m) == list(range(8))
    assert m[0][0] == "X" and m[0][7] == "NV18" and m[5][2] == "NV18"
    assert topology.nvlink_groups(m) == [list(range(8))]
    dom = topology.domain_from_probe(["NVIDIA H100 80GB HBM3"] * 8, HGX_8,
                                     FABRIC_HGX, env={}, uuids=UUIDS_A)
    assert dom == {"slice_id": "local-h100-8-" + _digest(UUIDS_A),
                   "domain_name": None,
                   "accelerator_type": "h100-8", "generation": "h100",
                   "worker_id": 0, "num_hosts": 1, "gpus_per_host": 8,
                   "nvlink_groups": [list(range(8))], "fabric": None}


def test_cuda_visible_devices_picks_the_cards(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,5")
    dom = topology.domain_from_probe(["NVIDIA H100 80GB HBM3"] * 2, HGX_8,
                                     "", env={})
    assert dom["nvlink_groups"] == [[2, 5]]
    assert dom["accelerator_type"] == "h100-2"


def test_topo_matrix_of_two_pcie_cards():
    m = topology.parse_topo_matrix(PCIE_2)
    assert m == {0: {0: "X", 1: "SYS"}, 1: {0: "SYS", 1: "X"}}
    assert topology.nvlink_groups(m) == [[0], [1]]
    dom = topology.domain_from_probe(["NVIDIA H100 PCIe"] * 2, PCIE_2, "",
                                     env={})
    # no NVLink between them: each card is a domain of one
    assert (dom["accelerator_type"], dom["gpus_per_host"],
            dom["nvlink_groups"]) == ("h100-1", 1, [[0], [1]])


def test_topo_matrix_of_one_card():
    m = topology.parse_topo_matrix(ONE_CARD)
    assert m == {0: {0: "X"}}
    dom = topology.domain_from_probe(["NVIDIA H100 80GB HBM3"], ONE_CARD, "",
                                     env={}, uuids=UUIDS_A[:1])
    assert (dom["slice_id"], dom["accelerator_type"], dom["num_hosts"],
            dom["nvlink_groups"]) == ("local-h100-1-" +
                                      _digest(UUIDS_A[:1]), "h100-1", 1,
                                      [[0]])
    # nvidia-smi missing or failing: the visible cards, one a group
    assert topology.domain_from_probe(["NVIDIA H100 80GB HBM3"], "", "",
                                      env={})["accelerator_type"] == "h100-1"


def test_fabric_block():
    assert topology.parse_fabric(FABRIC_NVL) == {
        "cluster_uuid": "2b5fb2e5-3fb2-4b3d-a8b2-1c5f9b5a7e10",
        "clique_id": "32766"}
    assert topology.parse_fabric(FABRIC_HGX) is None
    assert topology.parse_fabric("") is None
    four = ONE_CARD.replace("GPU0     X", "GPU0     X      NV18    NV18    "
                            "NV18")
    # Without a launcher the fabric is reported, not joined: nvidia-smi
    # names the clique but not its size or this host's rank in it, so the
    # host is a domain of its own (a per-host type under the clique's name
    # would be a domain of many rank-0 hosts that no gang could fill).
    dom = topology.domain_from_probe(["NVIDIA GB200"] * 1, four, FABRIC_NVL,
                                     env={}, uuids=UUIDS_A[:1])
    assert (dom["slice_id"], dom["accelerator_type"], dom["num_hosts"]) == \
        ("local-gb200-1-" + _digest(UUIDS_A[:1]), "gb200-1", 1)
    assert dom["fabric"]["clique_id"] == "32766"
    # A launcher's multi-host type and rank: the clique names the domain.
    env = {topology.ENV_TYPE: "gb200-72", topology.ENV_WORKER_ID: "5"}
    dom = topology.domain_from_probe(["NVIDIA GB200"] * 4, "", FABRIC_NVL,
                                     env=env)
    assert (dom["slice_id"], dom["worker_id"], dom["num_hosts"],
            dom["gpus_per_host"]) == (
        "fabric-2b5fb2e5-3fb2-4b3d-a8b2-1c5f9b5a7e10-32766", 5, 18, 4)
    # ... and with no fabric to name it, each host stays a domain of its
    # own that never completes, rather than one shared name.
    env[topology.ENV_WORKER_ID] = "0"
    dom = topology.domain_from_probe(["NVIDIA GB200"] * 4, "", "", env=env,
                                     uuids=UUIDS_A[:4])
    assert dom["slice_id"] == "local-gb200-72-" + _digest(UUIDS_A[:4])


def test_hosts_started_alike_are_domains_of_their_own(monkeypatch):
    """Two HGX hosts with no launcher read the same topology text; each
    names its domain after its own cards (the same cards, the same name),
    or after the host where the UUIDs are unknown."""
    a = topology.domain_from_probe(["NVIDIA H100 80GB HBM3"] * 8, HGX_8, "",
                                   env={}, uuids=UUIDS_A)
    b = topology.domain_from_probe(["NVIDIA H100 80GB HBM3"] * 8, HGX_8, "",
                                   env={}, uuids=UUIDS_B)
    assert a["accelerator_type"] == b["accelerator_type"] == "h100-8"
    assert a["slice_id"] != b["slice_id"]
    assert topology.domain_from_probe(
        ["NVIDIA H100 80GB HBM3"] * 8, HGX_8, "", env={},
        uuids=list(UUIDS_A))["slice_id"] == a["slice_id"]
    # CUDA_VISIBLE_DEVICES splits a host: each part is named by its cards
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    low = topology.domain_from_probe(["NVIDIA H100 80GB HBM3"] * 4, HGX_8, "",
                                     env={}, uuids=UUIDS_A[:4])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    high = topology.domain_from_probe(["NVIDIA H100 80GB HBM3"] * 4, HGX_8,
                                      "", env={}, uuids=UUIDS_A[4:])
    assert low["slice_id"] != high["slice_id"]
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    for host in ("hgx-0", "hgx-1"):
        monkeypatch.setattr(topology.socket, "gethostname", lambda: host)
        assert topology.domain_from_probe(
            ["NVIDIA H100 80GB HBM3"] * 8, HGX_8, "", env={}
        )["slice_id"] == "local-h100-8-" + _digest([host])


def test_launcher_environment_names_the_domain():
    env = {topology.ENV_DOMAIN: "rtpt-c-gpu-1234", topology.ENV_WORKER_ID: "1",
           topology.ENV_TYPE: "h100-16"}
    dom = topology.domain_from_probe(["NVIDIA H100 80GB HBM3"] * 8, HGX_8,
                                     FABRIC_NVL, env=env)
    assert (dom["slice_id"], dom["domain_name"], dom["worker_id"],
            dom["accelerator_type"], dom["num_hosts"],
            dom["gpus_per_host"]) == ("rtpt-c-gpu-1234", "rtpt-c-gpu-1234",
                                      1, "h100-16", 2, 8)


def test_no_driver_no_domain(monkeypatch):
    monkeypatch.setattr(topology, "_cache", None)
    monkeypatch.setattr(topology, "_domain_cache", None)
    monkeypatch.setattr(topology, "_driver_present", lambda: False)
    assert topology.local_gpu_count() == 0
    assert topology.detect_domain() is None
    assert topology.gpu_resources() == {}
    assert topology.domain_from_probe([], HGX_8, "", env={}) is None


def test_domain_without_a_probe_reads_nvidia_smi(monkeypatch):
    """A daemon that never probed (its resources were given) names the
    cards from ``nvidia-smi --query-gpu`` and imports no torch for it;
    ``CUDA_VISIBLE_DEVICES`` narrows the list by index or UUID."""
    listing = "".join(f"{i}, GPU-uuid-{i}, NVIDIA H100 80GB HBM3\n"
                      for i in range(8))

    def smi(*args, **kw):
        if args[0].startswith("--query-gpu"):
            return listing
        return HGX_8 if args == ("topo", "-m") else ""

    monkeypatch.setattr(topology, "_cache", None)
    monkeypatch.setattr(topology, "_driver_present", lambda: True)
    monkeypatch.setattr(topology, "_smi", smi)
    for var in (topology.ENV_DOMAIN, topology.ENV_TYPE,
                topology.ENV_WORKER_ID):
        monkeypatch.delenv(var, raising=False)
    for visible, want, cards in ((None, "h100-8", range(8)),
                                 ("3,4", "h100-2", (3, 4)),
                                 ("GPU-uuid-6", "h100-1", (6,))):
        monkeypatch.setattr(topology, "_domain_cache", None)
        if visible is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        dom = topology.detect_domain()
        assert dom["accelerator_type"] == want
        assert dom["slice_id"] == f"local-{want}-" + _digest(
            [f"GPU-uuid-{i}" for i in cards])
    assert topology._cache is None     # no probe ran


def test_gpu_resources_and_domain_from_a_probe(monkeypatch):
    monkeypatch.setattr(topology, "_cache", topology._Probe(
        8, ("9.0",) * 8, ("NVIDIA H100 80GB HBM3",) * 8))
    monkeypatch.setattr(topology, "_domain_cache", None)
    monkeypatch.setattr(topology, "_smi",
                        lambda *a, **k: HGX_8 if a == ("topo", "-m") else "")
    for var in (topology.ENV_DOMAIN, topology.ENV_TYPE,
                topology.ENV_WORKER_ID, "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    assert topology.gpu_resources() == {"GPU": 8.0, "GPU-h100": 8.0}
    assert topology.detect_domain()["accelerator_type"] == "h100-8"
    assert topology.is_sm90() and topology.local_gpu_count() == 8


def test_domain_spec_and_slice_spec_agree_on_host_counts():
    """The JAX slice of v4 (4 chips a host) and a GPU domain split the same
    way: hosts = ceil(units / per host), a host never more than its units."""
    from ray_tpu.tpu.topology import SliceSpec
    for n in (4, 8, 16, 32):
        s = SliceSpec.parse(f"v4-{n}")
        d = DomainSpec.parse(f"gb200-{n}")     # 4 cards a host
        assert (s.num_hosts, s.chips_per_host) == \
            (d.num_hosts, d.gpus_per_host)
