"""Per-task / per-actor option validation and defaults. Ported from
``ray_tpu/core/options.py``.

Role parity: python/ray/_private/ray_option_utils.py — a single table of
valid options with type/value checks, shared by ``@remote`` decorators and
``.options(...)`` overrides.

The accelerator option is ``num_gpus`` (cards) and its resource ``"GPU"``,
where the JAX package has ``num_tpus`` and ``"TPU"``. ``runtime_env`` is
checked key by key as the JAX package's ``RuntimeEnv`` checks it; nothing is
installed or packed (the in-process runtime applies no runtime env).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class TaskOptions:
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    resources: Dict[str, float] = field(default_factory=dict)
    num_returns: int = 1
    max_retries: Any = None        # None = config default; -1 = infinite
    retry_exceptions: Any = False  # bool or tuple of exception types
    name: str = ""
    scheduling_strategy: Any = None
    runtime_env: Optional[dict] = None
    _metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ActorOptions:
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    resources: Dict[str, float] = field(default_factory=dict)
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    name: str = ""
    namespace: str = ""
    lifetime: str = "ref_counted"  # or "detached"
    scheduling_strategy: Any = None
    runtime_env: Optional[dict] = None
    get_if_exists: bool = False


_TASK_KEYS = {f for f in TaskOptions.__dataclass_fields__ if not f.startswith("_")}
_ACTOR_KEYS = set(ActorOptions.__dataclass_fields__)


def _check_resources(opts) -> None:
    if opts.num_cpus < 0 or opts.num_gpus < 0:
        raise ValueError("num_cpus / num_gpus must be >= 0")
    if opts.num_gpus != int(opts.num_gpus) and opts.num_gpus > 1:
        raise ValueError("fractional num_gpus > 1 is not allowed (cards are "
                         "indivisible above one)")
    for k, v in opts.resources.items():
        if not isinstance(k, str) or (isinstance(v, (int, float)) and v < 0):
            raise ValueError(f"bad custom resource {k!r}: {v!r}")
        if k in ("CPU", "GPU"):
            raise ValueError(f"use num_cpus/num_gpus instead of resources[{k!r}]")


# The keys that ray_tpu/runtime_env.py refuses: they install packages at
# run time.
_RUNTIME_ENV_UNSUPPORTED = {"conda", "container"}


def validate_runtime_env(env: Optional[dict]) -> Optional[dict]:
    """The JAX package's ``RuntimeEnv`` key checks, without its installers:
    ``env_vars`` is Dict[str, str], ``working_dir`` and each ``py_modules``
    path exist, ``pip`` is a list of requirements or a dict with packages
    and a ``find_links`` directory; ``conda``, ``container`` and unknown
    keys raise."""
    if env is None:
        return None
    out: Dict[str, Any] = {}
    env = dict(env)
    env_vars = env.pop("env_vars", None)
    if env_vars is not None:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in env_vars.items()):
            raise TypeError("env_vars must be Dict[str, str]")
        out["env_vars"] = dict(env_vars)
    working_dir = env.pop("working_dir", None)
    if working_dir is not None:
        if not os.path.isdir(working_dir):
            raise ValueError(
                f"working_dir {working_dir!r} is not a directory")
        out["working_dir"] = working_dir
    py_modules = env.pop("py_modules", None)
    if py_modules is not None:
        for m in py_modules:
            if not os.path.exists(str(m)):
                raise ValueError(f"py_modules path {m!r} does not exist")
        out["py_modules"] = [str(m) for m in py_modules]
    pip = env.pop("pip", None)
    if pip is not None:
        if isinstance(pip, (list, tuple)):
            spec = {"packages": [str(p) for p in pip], "find_links": None}
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
        out["pip"] = spec
    for k in env:
        if k in _RUNTIME_ENV_UNSUPPORTED:
            raise ValueError(
                f"runtime_env field {k!r} requires package installation "
                "at runtime, which this deployment image disallows; "
                "bake dependencies into the image instead")
        raise ValueError(f"unknown runtime_env field {k!r}")
    return out


def make_task_options(base: Optional[TaskOptions] = None, **updates) -> TaskOptions:
    bad = set(updates) - _TASK_KEYS
    if bad:
        raise ValueError(f"Invalid task options: {sorted(bad)}; "
                         f"valid: {sorted(_TASK_KEYS)}")
    merged = TaskOptions(**{**(_as_dict(base, _TASK_KEYS) if base else {}), **updates})
    if merged.num_returns < 0:
        raise ValueError("num_returns must be >= 0")
    _check_resources(merged)
    if "runtime_env" in updates:
        merged.runtime_env = validate_runtime_env(merged.runtime_env)
    return merged


def make_actor_options(base: Optional[ActorOptions] = None, **updates) -> ActorOptions:
    bad = set(updates) - _ACTOR_KEYS
    if bad:
        raise ValueError(f"Invalid actor options: {sorted(bad)}; "
                         f"valid: {sorted(_ACTOR_KEYS)}")
    merged = ActorOptions(**{**(_as_dict(base, _ACTOR_KEYS) if base else {}), **updates})
    if merged.max_concurrency < 1:
        raise ValueError("max_concurrency must be >= 1")
    if merged.lifetime not in ("ref_counted", "detached"):
        raise ValueError("lifetime must be 'ref_counted' or 'detached'")
    if merged.max_restarts < -1:
        raise ValueError("max_restarts must be >= -1 (-1 = infinite)")
    _check_resources(merged)
    if "runtime_env" in updates:
        merged.runtime_env = validate_runtime_env(merged.runtime_env)
    return merged


def _as_dict(opts, keys) -> Dict[str, Any]:
    return {k: getattr(opts, k) for k in keys}

