"""GCE GPU-VM node provider. Takes the place of ``ray_tpu/autoscaler/gcp.py``
(the TPU-VM provider).

Role parity: python/ray/autoscaler/_private/gcp/node_provider.py — the
reference launches GCE instances through the googleapiclient. Here the
provider drives ``gcloud compute instances`` through an injectable
transport (``GceGpuApi``): production runs the ``gcloud`` CLI (no extra
dependency), tests inject a fake. As the JAX provider scales whole ICI
slices, this one scales whole NVLink domains (``gpu/topology.py``):

- a node type IS a domain type (``accelerator_type: "h100-8"``) plus the
  machine type of its hosts (``machine_type: "a3-highgpu-8g"``), so a
  scale-up creates every host of one domain, and the provider's node id is
  the domain's name, never a single VM (the ``SLICE`` strategy's unit);
- each host's startup script hands the node its domain (the name, its
  index and the type, in ``gpu.topology.ENV_*``) and joins it to the head
  with ``python -m ray_tpu_torch start --address=...``; the daemon's
  ``detect_domain`` reads them, and ``node_id_map`` joins on the name;
- scale-down deletes a domain only when every one of its hosts is idle
  (``StandardAutoscaler`` terminates per provider id), and deletes all its
  VMs together.
"""

from __future__ import annotations

import json
import re
import shlex
import subprocess
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.autoscaler import NodeProvider
from ray_tpu_torch.gpu.topology import (ENV_DOMAIN, ENV_TYPE, ENV_WORKER_ID,
                                        DomainSpec)


def _run_gcloud(cmd: List[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(
            f"gcloud failed ({' '.join(map(shlex.quote, cmd))}): "
            f"{out.stderr.strip()}")
    return out.stdout


class GceGpuApi:
    """Transport to the GCE instances control plane. Production: the gcloud
    CLI; ``runner`` takes the argv and returns stdout (raises on a failed
    call)."""

    def __init__(self, project: str, zone: str,
                 runner: Optional[Callable[[List[str]], str]] = None):
        self.project = project
        self.zone = zone
        self.runner = runner or _run_gcloud

    def _run(self, *args: str) -> str:
        return self.runner(["gcloud", "compute", "instances", *args,
                            f"--project={self.project}",
                            f"--zone={self.zone}", "--format=json"])

    def create(self, name: str, machine_type: str, startup_script: str,
               labels: Dict[str, str], image_family: str = "",
               image_project: str = "") -> None:
        args = ["create", name, f"--machine-type={machine_type}",
                "--maintenance-policy=TERMINATE",
                "--labels=" + ",".join(f"{k}={v}" for k, v in labels.items()),
                f"--metadata=startup-script={startup_script}"]
        if image_family:
            args.append(f"--image-family={image_family}")
        if image_project:
            args.append(f"--image-project={image_project}")
        self._run(*args)

    def delete(self, name: str) -> None:
        self._run("delete", name, "--quiet")

    def list(self, label_filter: Dict[str, str]) -> List[dict]:
        flt = " AND ".join(f"labels.{k}={v}"
                           for k, v in label_filter.items())
        out = self._run("list", f"--filter={flt}")
        return json.loads(out or "[]")


def _label(value: str) -> str:
    """A GCE label value or name part: lowercase letters, digits and dashes,
    at most 63 characters."""
    return re.sub(r"[^a-z0-9-]+", "-", value.lower())[:63]


class GceGpuNodeProvider(NodeProvider):
    """Domain-granular GPU-VM provider.

    node_types: {type_name: {"accelerator_type": "h100-8",
                             "machine_type": "a3-highgpu-8g",
                             "image_family": ..., "image_project": ...,
                             "resources": {...}, "max_workers": N}}

    The machine type carries the cards (the A2/A3/A4 families do), and the
    image (the role of the TPU VM's ``version``) must hold the driver,
    CUDA and this package.
    """

    CLUSTER_LABEL = "ray-tpu-torch-cluster"
    TYPE_LABEL = "ray-tpu-torch-node-type"
    DOMAIN_LABEL = "ray-tpu-torch-gpu-domain"

    def __init__(self, conductor_address: str, node_types: Dict[str, dict],
                 *, cluster_name: str = "default",
                 api: Optional[GceGpuApi] = None, project: str = "",
                 zone: str = ""):
        self.conductor_address = conductor_address
        self.node_types = node_types
        self.cluster_name = cluster_name
        self.api = api if api is not None else GceGpuApi(project, zone)

    def _startup_script(self, domain: str, worker_id: int,
                        accelerator_type: str) -> str:
        # Every host of the domain joins as a daemon and reports the domain
        # it was created in (gpu/topology.py detect_domain reads these).
        return ("#!/bin/bash\n"
                f"export {ENV_DOMAIN}={shlex.quote(domain)}\n"
                f"export {ENV_WORKER_ID}={worker_id}\n"
                f"export {ENV_TYPE}={shlex.quote(accelerator_type)}\n"
                f"python3 -m ray_tpu_torch start "
                f"--address={self.conductor_address} --block\n")

    def create_node(self, node_type: str) -> str:
        """Create every host of one domain of ``node_type``; returns the
        domain's name (the provider node id)."""
        cfg = self.node_types[node_type]
        spec = DomainSpec.parse(cfg["accelerator_type"])
        # The uuid keeps each domain's name its own (scale-down joins on
        # it), so the prefix is what gets cut: 50 + 9 characters leave room
        # for the hosts' "-<w>" within GCE's 63 for a VM's name.
        prefix = _label(f"rtpt-{self.cluster_name}-{node_type}")[:50]
        domain = f"{prefix.rstrip('-')}-{uuid.uuid4().hex[:8]}"
        labels = {self.CLUSTER_LABEL: _label(self.cluster_name),
                  self.TYPE_LABEL: _label(node_type),
                  self.DOMAIN_LABEL: domain}
        for w in range(spec.num_hosts):
            self.api.create(
                f"{domain}-{w}", cfg["machine_type"],
                self._startup_script(domain, w, spec.accelerator_type),
                labels, image_family=cfg.get("image_family", ""),
                image_project=cfg.get("image_project", ""))
        return domain

    def terminate_node(self, provider_id: str) -> None:
        """Delete every VM of domain ``provider_id``. Idempotent: a VM
        already gone (a prior pass won the race) must not crash the
        autoscaler's reconcile loop."""
        vms = self.api.list({self.CLUSTER_LABEL: _label(self.cluster_name),
                             self.DOMAIN_LABEL: provider_id})
        for vm in vms:
            try:
                self.api.delete(vm["name"].rsplit("/", 1)[-1])
            except RuntimeError:
                pass

    # VM states that serve no capacity and should neither count against
    # max_workers nor block replacement launches.
    _DEAD_STATES = ("STOPPING", "STOPPED", "SUSPENDING", "SUSPENDED",
                    "TERMINATED", "REPAIRING")

    def non_terminated_nodes(self) -> List[Tuple[str, str]]:
        """One (domain, type) for each domain with a VM still serving."""
        vms = self.api.list({self.CLUSTER_LABEL: _label(self.cluster_name)})
        out: Dict[str, str] = {}
        for vm in vms:
            if vm.get("status") in self._DEAD_STATES:
                continue
            labels = vm.get("labels") or {}
            domain = labels.get(self.DOMAIN_LABEL)
            if domain:
                out.setdefault(domain, self._type_of(labels))
        return sorted(out.items())

    def _type_of(self, labels: Dict[str, str]) -> str:
        """The node type a VM's labels name (labels are lowercased)."""
        value = labels.get(self.TYPE_LABEL, "")
        return next((t for t in self.node_types if _label(t) == value),
                    value)

    def node_id_map(self) -> Dict[bytes, str]:
        """cluster node_id -> domain name, joined on the domain name each
        host's daemon reports (``gpu_domain["domain_name"]``, from the
        startup script's environment)."""
        from ray_tpu_torch.cluster.protocol import get_client
        try:
            nodes = get_client(self.conductor_address).call("get_nodes")
        except Exception:
            return {}
        # Membership comes from the label-filtered CLOUD listing (survives
        # provider restarts), not process-local create history.
        known = {name for name, _ in self.non_terminated_nodes()}
        mapping: Dict[bytes, str] = {}
        for n in nodes:
            name = (n.get("gpu_domain") or {}).get("domain_name")
            if name in known:
                mapping[n["node_id"]] = name
        return mapping
