"""Backend plugin registry + cross-project index registry.

Capability parity with the reference's registry
(leann-core/src/leann/registry.py:16-98): a name -> factory map populated by
``@register_backend``, plus a per-user projects file so ``leann list`` can
discover indexes across project directories.

Unlike the reference (which scans installed ``leann-backend-*`` distributions
via importlib.metadata), all backends here live in-tree under
``leann_torch.backends`` and are imported lazily on first use — there is no
separate wheel per backend.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Dict, List, Type

if TYPE_CHECKING:
    from .interface import LeannBackendFactoryInterface

logger = logging.getLogger(__name__)

BACKEND_REGISTRY: Dict[str, "Type[LeannBackendFactoryInterface]"] = {}

# name -> module path imported on demand by autodiscover_backends()
_BUILTIN_BACKENDS = {
    "flat": "leann_torch.backends.flat",
    "diskann": "leann_torch.backends.diskann",
}

# backends of the JAX package this port does not carry yet -> ROADMAP.md item
_NOT_PORTED = {
    "hnsw": "ROADMAP.md, left for later #1 (HNSW backend)",
}


def register_backend(name: str) -> Callable:
    """Class decorator registering a backend factory under ``name``."""

    def decorator(cls):
        if name in BACKEND_REGISTRY and BACKEND_REGISTRY[name] is not cls:
            logger.debug("backend %r re-registered", name)
        BACKEND_REGISTRY[name] = cls
        return cls

    return decorator


def autodiscover_backends() -> Dict[str, "Type[LeannBackendFactoryInterface]"]:
    """Import every built-in backend module so its ``@register_backend``
    decorator runs. Safe to call repeatedly."""
    for name, module in _BUILTIN_BACKENDS.items():
        if name in BACKEND_REGISTRY:
            continue
        try:
            importlib.import_module(module)
        except Exception as e:  # pragma: no cover - import failure is fatal in tests
            logger.warning("failed to import backend %r: %s", name, e)
    return BACKEND_REGISTRY


def get_registered_backends() -> List[str]:
    autodiscover_backends()
    return sorted(BACKEND_REGISTRY.keys())


def get_backend(name: str) -> "Type[LeannBackendFactoryInterface]":
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {name!r} is not ported to leann_torch yet: {_NOT_PORTED[name]}")
    autodiscover_backends()
    if name not in BACKEND_REGISTRY:
        raise ValueError(
            f"Unknown backend {name!r}. Registered: {sorted(BACKEND_REGISTRY)}"
        )
    return BACKEND_REGISTRY[name]


# ---------------------------------------------------------------------------
# Project registry (reference registry.py:50-98): records directories that
# contain .leann indexes in ~/.leann_torch/projects.json so the CLI can list /
# remove indexes from anywhere.
# ---------------------------------------------------------------------------


def _projects_file() -> Path:
    root = Path(os.environ.get("LEANN_HOME", Path.home() / ".leann_torch"))
    return root / "projects.json"


def load_project_directories() -> List[str]:
    f = _projects_file()
    if not f.exists():
        return []
    try:
        data = json.loads(f.read_text())
        dirs = data.get("project_directories", [])
        return [d for d in dirs if Path(d).exists()]
    except (json.JSONDecodeError, OSError):
        return []


def register_project_directory(project_dir: "str | Path") -> None:
    project_dir = str(Path(project_dir).resolve())
    f = _projects_file()
    f.parent.mkdir(parents=True, exist_ok=True)
    dirs = load_project_directories()
    if project_dir not in dirs:
        dirs.append(project_dir)
    f.write_text(json.dumps({"project_directories": dirs}, indent=2))


def unregister_project_directory(project_dir: "str | Path") -> None:
    project_dir = str(Path(project_dir).resolve())
    f = _projects_file()
    dirs = [d for d in load_project_directories() if d != project_dir]
    if f.parent.exists():
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(json.dumps({"project_directories": dirs}, indent=2))
