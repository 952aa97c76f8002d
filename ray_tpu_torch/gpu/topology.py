"""Local GPU count and generation, for the cluster runtime's ``"GPU"``
resource, and the NVLink domain model. Takes the place of
``ray_tpu/tpu/topology.py`` (``local_chip_count``, ``SliceSpec``,
``detect_slice``, ``tpu_resources``).

The count must not initialise CUDA in the asking process: the head's
node daemon runs in the driver, and a process whose CUDA is initialised
cannot hand a working CUDA to a child it forks. So the answer comes from
the driver's own CUDA when that is already initialised, else from a
short-lived subprocess, and is cached for the life of the process. A host
with no NVIDIA driver node answers 0 without a probe. ``CUDA_VISIBLE_DEVICES``
is honoured as CUDA honours it.

The NVLink domain is the GPU counterpart of the TPU slice: the set of
cards that one NCCL program's fast collectives span. On an HGX board it is
the host's NVLink/NVSwitch-connected cards; with a multi-node NVLink
fabric (GB200 NVL72) it spans several hosts, which the launcher that
started them names (``ENV_*`` below). The scheduler gang-places a
``"SLICE"`` placement group on the hosts of one domain
(``cluster/conductor.py``), and the GPU-VM provider scales whole domains
(``autoscaler/gce.py``). ``detect_domain`` reads this host's membership
from ``nvidia-smi``, a process of its own, so it too leaves the asking
process's CUDA untouched (and imports no torch: the visible cards' names
come from the probe where it ran, else from ``nvidia-smi``'s list); the
parsers are pure functions of ``nvidia-smi``'s text.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import re
import socket
import subprocess
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

# Cards per host of each generation's standard NVLink board, from the
# public system documentation: HGX A100/H100/H200/B200 boards hold 8
# SXM cards on NVSwitch; a GB200 compute tray holds 4 (an NVL72 rack's
# fabric joins 18 of them); a GH200 superchip has one.
_GPUS_PER_HOST: Dict[str, int] = {
    "a100": 8,
    "h100": 8,
    "h200": 8,
    "b200": 8,
    "gb200": 4,
    "gh200": 1,
}

# Environment a launcher hands a node it starts (the role of the TPU VM's
# TPU_NAME / TPU_WORKER_ID / TPU_ACCELERATOR_TYPE): the domain's name, this
# host's index in it, and the domain's type.
ENV_DOMAIN = "RAY_TPU_TORCH_GPU_DOMAIN"
ENV_WORKER_ID = "RAY_TPU_TORCH_GPU_DOMAIN_WORKER_ID"
ENV_TYPE = "RAY_TPU_TORCH_GPU_DOMAIN_TYPE"


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """A requested or discovered NVLink domain.

    ``accelerator_type`` reads ``"<generation>-<cards>"``, e.g. ``"h100-8"``
    (one HGX H100 board) or ``"gb200-72"`` (an NVL72 rack of 18 hosts).
    """
    generation: str          # "h100", "gb200", ...
    num_gpus: int
    per_host: Optional[int] = None   # None: the generation's table entry

    @property
    def accelerator_type(self) -> str:
        return f"{self.generation}-{self.num_gpus}"

    @property
    def gpus_per_host(self) -> int:
        per = self.per_host or _GPUS_PER_HOST.get(self.generation, 8)
        return min(self.num_gpus, per)

    @property
    def num_hosts(self) -> int:
        return max(1, math.ceil(self.num_gpus / self.gpus_per_host))

    @staticmethod
    def parse(accelerator_type: str) -> "DomainSpec":
        """Parse ``"h100-8"`` / ``"gb200-72"`` style names."""
        m = re.fullmatch(r"([a-z]+\d+[a-z]*)-(\d+)", accelerator_type)
        if not m or m.group(1) not in _GPUS_PER_HOST or int(m.group(2)) < 1:
            raise ValueError(
                f"Bad accelerator type {accelerator_type!r}; expected "
                f"'<generation>-<cards>' with a generation of "
                f"{sorted(_GPUS_PER_HOST)}, e.g. 'h100-8'")
        return DomainSpec(m.group(1), int(m.group(2)))


# ---------------------------------------------------------------------------
# nvidia-smi parsers (pure functions of its text)
# ---------------------------------------------------------------------------

_ANSI = re.compile(r"\x1b\[[0-9;]*m")


def generation_from_name(name: str) -> str:
    """``"NVIDIA H100 80GB HBM3"`` -> ``"h100"``; ``"NVIDIA GB200"`` ->
    ``"gb200"``; ``""`` for a name with no generation in it."""
    m = re.search(r"(?<![A-Za-z0-9])(GB|GH|[ABHL])(\d{2,3})", name,
                  re.IGNORECASE)
    return (m.group(1) + m.group(2)).lower() if m else ""


def parse_topo_matrix(text: str) -> Dict[int, Dict[int, str]]:
    """``nvidia-smi topo -m``'s GPU-to-GPU block: ``{i: {j: link}}`` with
    links such as ``"X"``, ``"NV18"``, ``"SYS"``, ``"PIX"``."""
    lines = [_ANSI.sub("", ln) for ln in text.splitlines()]
    header = next((ln.split() for ln in lines
                   if re.match(r"\s*GPU\d+\b", ln) and "X" not in ln.split()),
                  None)
    if header is None:
        return {}
    cols = []
    for tok in header:
        if not re.fullmatch(r"GPU\d+", tok):
            break
        cols.append(int(tok[3:]))
    out: Dict[int, Dict[int, str]] = {}
    for ln in lines:
        toks = ln.split()
        if len(toks) <= len(cols) or not re.fullmatch(r"GPU\d+", toks[0]) \
                or "X" not in toks[1:len(cols) + 1]:
            continue
        out[int(toks[0][3:])] = dict(zip(cols, toks[1:len(cols) + 1]))
    return out


def nvlink_groups(matrix: Dict[int, Dict[int, str]],
                  visible: Optional[List[int]] = None) -> List[List[int]]:
    """Connected components of the cards joined by ``NV<n>`` links, over
    ``visible`` (default: every card of the matrix), largest first."""
    cards = sorted(matrix) if visible is None else list(visible)
    seen, groups = set(), []
    for start in cards:
        if start in seen:
            continue
        group, stack = [], [start]
        seen.add(start)
        while stack:
            i = stack.pop()
            group.append(i)
            for j, link in matrix.get(i, {}).items():
                if j in cards and j not in seen and link.startswith("NV"):
                    seen.add(j)
                    stack.append(j)
        groups.append(sorted(group))
    return sorted(groups, key=lambda g: (-len(g), g))


def parse_fabric(text: str) -> Optional[Dict[str, str]]:
    """The first card's ``Fabric`` block of ``nvidia-smi -q``:
    ``{"cluster_uuid", "clique_id"}`` when the card belongs to a multi-node
    NVLink fabric, else None (no block, state not completed, or the all-zero
    UUID of a board whose NVSwitches serve only itself)."""
    lines = text.splitlines()
    for k, ln in enumerate(lines):
        if ln.strip() != "Fabric":
            continue
        indent = len(ln) - len(ln.lstrip())
        fields = {}
        for sub in lines[k + 1:]:
            if sub.strip() and len(sub) - len(sub.lstrip()) <= indent:
                break
            key, sep, val = sub.partition(":")
            if sep:
                fields[key.strip()] = val.strip()
        uuid = fields.get("ClusterUUID", "")
        if fields.get("State") != "Completed" or not uuid \
                or uuid == "N/A" or set(uuid) <= set("0-"):
            return None
        return {"cluster_uuid": uuid, "clique_id": fields.get("CliqueId", "")}
    return None


def _visible_indices(n: int) -> List[int]:
    """The driver indices of the ``n`` cards CUDA sees: those named by
    ``CUDA_VISIBLE_DEVICES`` when it lists indices, else 0..n-1 (``nvidia-smi``
    numbers cards in PCI order, which is CUDA's order for one model)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env:
        toks = [t.strip() for t in env.split(",") if t.strip()]
        if toks and all(t.isdigit() for t in toks):
            return [int(t) for t in toks][:n]
    return list(range(n))


def _local_domain_id(accelerator_type: str,
                     uuids: Optional[List[str]]) -> str:
    """The name of a domain that lies on this host alone: its type and a
    digest of the visible cards' UUIDs, which no other card shares (of the
    host's name where the UUIDs are unknown). Every host of a fleet started
    alike reports the same type, so the type alone would merge them all
    into one domain in the scheduler's view."""
    key = ",".join(uuids) if uuids else socket.gethostname()
    digest = hashlib.sha1(key.encode()).hexdigest()[:12]
    return f"local-{accelerator_type}-{digest}"


def domain_from_probe(names: List[str], topo_text: str, fabric_text: str,
                      env: Optional[Dict[str, str]] = None,
                      uuids: Optional[List[str]] = None) -> Optional[dict]:
    """This host's domain from what the probe read: the visible cards'
    names and UUIDs, ``nvidia-smi topo -m`` and ``nvidia-smi -q``.

    The launcher's environment (``ENV_*``), when set, gives the domain's
    type, this host's index in it and its name. A domain spans hosts only
    where that type says so; its name is then the launcher's, else the
    fabric's clique (``nvidia-smi -q``), and a host with neither reports a
    domain of its own that never completes. Without a launcher the domain
    is the largest NVLink group of this host's cards (cards with no NVLink
    between them are domains of one card each), named after its cards: a
    multi-node fabric's size and this host's place in it are not in
    ``nvidia-smi``'s text, so the fabric is reported but not joined. None
    with no card."""
    env = os.environ if env is None else env
    if not names:
        return None
    gen = generation_from_name(names[0]) or "gpu"
    visible = _visible_indices(len(names))
    matrix = parse_topo_matrix(topo_text)
    groups = (nvlink_groups(matrix, visible)
              if all(i in matrix for i in visible)
              else [[i] for i in visible])
    local = len(groups[0])
    fabric = parse_fabric(fabric_text)
    at = env.get(ENV_TYPE, "")
    if at:
        spec = DomainSpec.parse(at)
    else:
        spec = DomainSpec(gen, local, per_host=local)
    name = env.get(ENV_DOMAIN) or None
    if name:
        domain_id = name
    elif spec.num_hosts > 1 and fabric is not None:
        domain_id = f"fabric-{fabric['cluster_uuid']}-{fabric['clique_id']}"
    else:
        domain_id = _local_domain_id(spec.accelerator_type, uuids)
    return {
        "slice_id": domain_id,
        # The launcher's name for the domain (its VMs share it): a cloud
        # provider joins on it for scale-down (autoscaler/gce.py).
        "domain_name": name,
        "accelerator_type": spec.accelerator_type,
        "generation": spec.generation,
        "worker_id": int(env.get(ENV_WORKER_ID, "0") or 0),
        "num_hosts": spec.num_hosts,
        "gpus_per_host": spec.gpus_per_host,
        "nvlink_groups": groups,
        "fabric": fabric,
    }


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

_PROBE_SRC = (
    "import torch\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "cc = [torch.cuda.get_device_capability(i) for i in range(n)]\n"
    "print(n, *(f'{a}.{b}' for a, b in cc))\n"
    "for i in range(n):\n"
    "    print(torch.cuda.get_device_name(i))\n")


class _Probe(NamedTuple):
    count: int
    caps: Tuple[str, ...]
    names: Tuple[str, ...]


_cache: Optional[_Probe] = None
_domain_cache: Optional[Tuple[Optional[dict]]] = None
_NONE = _Probe(0, (), ())


def _driver_present() -> bool:
    return (os.path.exists("/proc/driver/nvidia/version")
            or os.path.exists("/dev/nvidia0"))


def _probe(timeout_s: float = 60.0) -> _Probe:
    if os.environ.get("CUDA_VISIBLE_DEVICES", None) == "":
        return _NONE
    if not _driver_present():
        return _NONE
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        n = torch.cuda.device_count()
        return _Probe(n, tuple("%d.%d" % torch.cuda.get_device_capability(i)
                               for i in range(n)),
                      tuple(torch.cuda.get_device_name(i) for i in range(n)))
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE_SRC],
                             capture_output=True, text=True,
                             timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired):
        return _NONE
    if out.returncode != 0:
        return _NONE
    lines = out.stdout.splitlines()
    fields = lines[0].split()
    n = int(fields[0])
    return _Probe(n, tuple(fields[1:]), tuple(lines[1:1 + n]))


def _info() -> _Probe:
    global _cache
    if _cache is None:
        _cache = _probe()
    return _cache


def _smi(*args: str, timeout_s: float = 30.0) -> str:
    """``nvidia-smi``'s output, or "" where it is missing or fails. It is a
    process of its own, so it leaves this process's CUDA untouched."""
    try:
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout if out.returncode == 0 else ""


def _visible_cards() -> Tuple[List[str], List[str]]:
    """The names and UUIDs of the cards CUDA sees, from ``nvidia-smi``'s
    list narrowed to the indices or UUIDs that ``CUDA_VISIBLE_DEVICES``
    names (no torch import, no probe); the names are the probe's where it
    ran in this process. The UUIDs are empty where ``nvidia-smi`` gives no
    list."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    rows = []
    if env != "" and _driver_present():
        rows = [[f.strip() for f in line.split(",", 2)]
                for line in _smi("--query-gpu=index,uuid,name",
                                 "--format=csv,noheader").splitlines()
                if line.count(",") >= 2]
    if env:
        by_id = {key: r for r in rows for key in r[:2]}
        rows = [by_id[t.strip()] for t in env.split(",")
                if t.strip() in by_id]
    if _cache is not None:
        names = list(_cache.names)
        return names, ([r[1] for r in rows] if len(rows) == len(names)
                       else [])
    return [r[2] for r in rows], [r[1] for r in rows]


def local_gpu_count() -> int:
    """Cards this host offers to the runtime (0 without a driver)."""
    return _info().count


def is_sm90() -> bool:
    """True when every local card is compute capability 9.0 (Hopper)."""
    info = _info()
    return info.count > 0 and all(c == "9.0" for c in info.caps)


def detect_domain() -> Optional[dict]:
    """This host's NVLink-domain membership for the scheduler (the role of
    ``detect_slice``): ``slice_id`` (the domain), ``domain_name``,
    ``accelerator_type``, ``generation``, ``worker_id``, ``num_hosts``,
    ``gpus_per_host``, ``nvlink_groups`` and ``fabric``. None with no
    driver or no card. Cached for the life of the process."""
    global _domain_cache
    if _domain_cache is None:
        names, uuids = _visible_cards()
        dom = None
        if names:
            dom = domain_from_probe(names, _smi("topo", "-m"), _smi("-q"),
                                    uuids=uuids)
        _domain_cache = (dom,)
    return _domain_cache[0]


def gpu_resources() -> Dict[str, float]:
    """Resource dict a node daemon advertises for its local cards: the
    generic ``"GPU"`` count and a typed ``"GPU-<gen>"`` one, so tasks can
    target a generation (the role of ``tpu_resources``)."""
    info = _info()
    if not info.count:
        return {}
    n = float(info.count)
    gen = generation_from_name(info.names[0]) if info.names else ""
    return {"GPU": n, **({f"GPU-{gen}": n} if gen else {})}
