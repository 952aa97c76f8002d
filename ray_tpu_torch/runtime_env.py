"""RuntimeEnv: per-task/actor environment spec.

Role parity: python/ray/runtime_env/runtime_env.py — a validated dict of
environment customizations applied when the worker pool spawns a process
for that env (node_daemon._spawn_worker): ``env_vars`` merge into the
worker's environment, ``working_dir`` becomes its cwd, ``py_modules`` are
packaged at validation time (zip, content-addressed) and unpacked onto the
worker's PYTHONPATH on the executing node (the role of the reference's
runtime-env agent + GCS package store, _private/runtime_env/py_modules.py).
Workers are cached per runtime-env hash (dedicated-worker behavior).

``pip`` environments (parity: _private/runtime_env/pip.py) build a venv
per spec hash with --system-site-packages and install OFFLINE
(``--no-index``): packages resolve from a ``find_links`` wheel directory
or local paths only — this image has no network egress, so index installs
fail fast with pip's own error. Workers for such envs run on the venv's
interpreter. Conda/container plugins raise upfront.
"""

from __future__ import annotations

import base64
import hashlib
import io
import os
import zipfile
from typing import Any, Dict, List, Optional

_SUPPORTED = {"env_vars", "working_dir", "py_modules", "pip"}
_KNOWN_UNSUPPORTED = {"conda", "container"}
_MAX_MODULE_ZIP = 64 << 20


def _pack_module(path: str) -> Dict[str, str]:
    """Zip one module (package dir or single .py) into a portable record.
    Content-addressed so daemons extract each version exactly once."""
    path = os.path.abspath(path)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        if os.path.isfile(path):
            z.write(path, os.path.basename(path))
        elif os.path.isdir(path):
            base = os.path.basename(path.rstrip("/"))
            for root, _dirs, files in os.walk(path):
                for f in files:
                    if f.endswith((".pyc", ".pyo")):
                        continue
                    full = os.path.join(root, f)
                    z.write(full, os.path.join(
                        base, os.path.relpath(full, path)))
        else:
            raise ValueError(f"py_module path {path!r} does not exist")
    raw = buf.getvalue()
    if len(raw) > _MAX_MODULE_ZIP:
        raise ValueError(
            f"py_module {path!r} packs to {len(raw)} bytes "
            f"(limit {_MAX_MODULE_ZIP}); ship big deps in the image")
    return {"name": os.path.basename(path),
            "sha": hashlib.sha256(raw).hexdigest()[:16],
            "zip_b64": base64.b64encode(raw).decode()}


def unpack_py_modules(records: List[dict], dest_root: str) -> str:
    """Daemon-side: extract packed modules under dest_root; returns the
    PYTHONPATH entry to prepend. Idempotent per content hash, and safe
    under concurrent spawns: extraction goes to a private temp dir that is
    atomically renamed into place (a second extractor either loses the
    rename race harmlessly or sees the finished directory)."""
    import tempfile

    paths = []
    for rec in records:
        out_dir = os.path.join(dest_root, rec["sha"])
        if not os.path.isdir(out_dir):
            os.makedirs(dest_root, exist_ok=True)
            tmp = tempfile.mkdtemp(dir=dest_root,
                                   prefix=f".{rec['sha']}-")
            raw = base64.b64decode(rec["zip_b64"])
            with zipfile.ZipFile(io.BytesIO(raw)) as z:
                z.extractall(tmp)
            try:
                os.rename(tmp, out_dir)
            except OSError:
                import shutil
                shutil.rmtree(tmp, ignore_errors=True)  # lost the race
        paths.append(out_dir)
    return os.pathsep.join(paths)


def env_fingerprint(env: Optional[dict]) -> str:
    """Stable, COMPACT identity for a runtime env: packed module blobs are
    replaced by their content hashes so scheduling keys and worker-cache
    keys never serialize megabytes of zip data."""
    if not env:
        return ""
    import json
    slim = dict(env)
    if slim.get("py_modules"):
        slim["py_modules"] = [
            {"name": r.get("name"), "sha": r.get("sha")}
            for r in slim["py_modules"]]
    return json.dumps(slim, sort_keys=True, default=str)


class RuntimeEnv(dict):
    def __init__(self, *, env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None,
                 py_modules: Optional[List[str]] = None,
                 pip: Optional[Any] = None, **kwargs):
        super().__init__()
        if env_vars is not None:
            if not all(isinstance(k, str) and isinstance(v, str)
                       for k, v in env_vars.items()):
                raise TypeError("env_vars must be Dict[str, str]")
            self["env_vars"] = dict(env_vars)
        if working_dir is not None:
            if not os.path.isdir(working_dir):
                raise ValueError(
                    f"working_dir {working_dir!r} is not a directory")
            self["working_dir"] = working_dir
        if py_modules is not None:
            packed = []
            for m in py_modules:
                if isinstance(m, dict) and "zip_b64" in m:
                    packed.append(dict(m))  # already packed (re-validation)
                else:
                    packed.append(_pack_module(str(m)))
            self["py_modules"] = packed
        if pip is not None:
            # Normalize: ["pkg", ...] or {"packages": [...],
            # "find_links": dir}. Stored small and hashable.
            if isinstance(pip, (list, tuple)):
                spec = {"packages": [str(p) for p in pip],
                        "find_links": None}
            elif isinstance(pip, dict):
                spec = {"packages": [str(p) for p in pip.get("packages", [])],
                        "find_links": pip.get("find_links")}
            else:
                raise TypeError("pip must be a list of requirements or a "
                                "dict with packages/find_links")
            if not spec["packages"]:
                raise ValueError("pip spec has no packages")
            if (spec["find_links"] is not None
                    and not os.path.isdir(spec["find_links"])):
                raise ValueError(
                    f"pip find_links {spec['find_links']!r} is not a "
                    "directory (offline installs need a local wheel dir)")
            self["pip"] = spec
        for k in kwargs:
            if k in _KNOWN_UNSUPPORTED:
                raise ValueError(
                    f"runtime_env field {k!r} requires package installation "
                    "at runtime, which this deployment image disallows; "
                    "bake dependencies into the image instead")
            raise ValueError(f"unknown runtime_env field {k!r}")

    def to_dict(self) -> Dict[str, Any]:
        return dict(self)


def validate_runtime_env(env: Optional[dict]) -> Optional[dict]:
    if env is None:
        return None
    if isinstance(env, RuntimeEnv):
        return env.to_dict()
    return RuntimeEnv(**env).to_dict()


_pip_env_locks: Dict[str, Any] = {}
_pip_env_locks_guard = None


def _pip_lock(key: str):
    global _pip_env_locks_guard
    import threading
    if _pip_env_locks_guard is None:
        _pip_env_locks_guard = threading.Lock()
    with _pip_env_locks_guard:
        return _pip_env_locks.setdefault(key, threading.Lock())


def ensure_pip_env(spec: Dict[str, Any], session_dir: str) -> str:
    """Daemon-side (runtime-env agent role, _private/runtime_env/pip.py):
    materialize the venv for a pip spec and return its python executable.
    Cached per spec hash; --system-site-packages keeps the image's baked
    deps (jax et al.) visible; installs are strictly OFFLINE (--no-index
    [--find-links dir]) because this image has no egress."""
    import hashlib
    import json
    import subprocess
    import sys

    from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError

    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()
                         ).hexdigest()[:16]
    root = os.path.join(session_dir, "pip_envs", key)
    py = os.path.join(root, "bin", "python")
    marker = os.path.join(root, ".ready")
    if os.path.exists(marker):
        return py
    # Per-spec build lock: the daemon's RPC server is threaded, and two
    # concurrent leases for the same env must not race `venv` + `pip`
    # into one directory (a corrupted build would read as a DETERMINISTIC
    # env failure and fail-fast every queued task).
    with _pip_lock(key):
        if os.path.exists(marker):
            return py
        try:
            _build_pip_env(spec, root, py)
        except RuntimeEnvSetupError:
            raise
        except Exception as e:  # venv/ensurepip/site-probe failures
            raise RuntimeEnvSetupError(
                f"pip runtime_env venv build failed: {e!r}") from e
        with open(marker, "w") as f:
            f.write("ok")
    return py


def _build_pip_env(spec: Dict[str, Any], root: str, py: str) -> None:
    import json
    import subprocess
    import sys

    import shutil
    shutil.rmtree(root, ignore_errors=True)   # clear any partial build
    subprocess.run([sys.executable, "-m", "venv",
                    "--system-site-packages", root],
                   check=True, capture_output=True)
    # When the PARENT interpreter is itself a venv (a container image often is),
    # --system-site-packages points at the base python, not the parent —
    # so the image's baked deps (jax, cloudpickle, ...) would vanish.
    # A .pth in the child exposes the parent's site-packages explicitly.
    import site
    child_site = subprocess.run(
        [py, "-c", "import site, json;"
         "print(json.dumps(site.getsitepackages()))"],
        check=True, capture_output=True, text=True)
    child_dirs = json.loads(child_site.stdout)
    parent_dirs = [d for d in site.getsitepackages()
                   if d not in child_dirs and os.path.isdir(d)]
    if child_dirs and parent_dirs:
        with open(os.path.join(child_dirs[0], "_parent_site.pth"),
                  "w") as f:
            f.write("\n".join(parent_dirs) + "\n")
    cmd = [py, "-m", "pip", "install", "--no-index",
           "--disable-pip-version-check"]
    if spec.get("find_links"):
        cmd += ["--find-links", spec["find_links"]]
    cmd += spec["packages"]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError
        raise RuntimeEnvSetupError(
            f"pip runtime_env install failed (offline --no-index; provide "
            f"find_links with local wheels): {out.stderr.strip()[-500:]}")
