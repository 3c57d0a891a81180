"""Device meshes and the two collectives of the port's parallel layer.

Counterpart of the JAX package's ``parallel/mesh.py``. Axis conventions:

* ``gp``: graph-parallel. Index rows (graph, PQ codes, tokens, embeddings)
  are block-partitioned over it; a query's frontier is combined across the
  shards by :func:`psum` (``sharded_search.py``), and the build rotates
  row tiles around it by :func:`ppermute` (``sharded_build.py``).
* ``dp`` / ``tp``: data / tensor axes of encoder fine-tuning (``train.py``);
  ``dp`` also splits a serving batch (:func:`serving_mesh`).

The JAX layer runs one controller over all devices; so does this one. A
:class:`Mesh` is an array of ``torch.device`` in which one device may stand
several times: 8 shards of the CPU, or 4 shards of ``cuda:0`` on a machine
with one card, run the same shard logic as 8 or 4 cards. A sharded array is
a list of per-shard tensors, each on its shard's device; there is no
process group.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


class Mesh:
    """Devices laid out over named axes, as ``jax.sharding.Mesh``:
    ``devices`` is an object array of ``torch.device`` shaped by the axis
    sizes, ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims with axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def cards() -> List[torch.device]:
    """Every CUDA card of the machine; raises without CUDA."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_devices(device: "str | torch.device", shards: int = 0) -> List[torch.device]:
    """The devices of a ``gp`` mesh for an entry point that runs on
    ``device``: ``shards`` <= 0 means one shard per card (a CPU device: one
    shard); otherwise ``shards`` shards laid over the cards in blocks (a
    CPU device: all on the CPU), so that one device's shards are
    neighbours."""
    dev = resolve_device(device)
    devs = cards() if dev.type == "cuda" else [dev]
    if shards <= 0:
        return devs
    return [devs[i * len(devs) // shards] for i in range(shards)]


def make_mesh(axes: Sequence[Tuple[str, int]], devices: Optional[list] = None) -> Mesh:
    """make_mesh([("dp", 2), ("tp", 4)]) -> a Mesh over the first
    prod(sizes) of ``devices`` (default: the cards), reshaped to the axis
    sizes. A device may appear more than once."""
    devices = cards() if devices is None else [torch.device(d) for d in devices]
    names = [a for a, _ in axes]
    sizes = [int(s) for _, s in axes]
    need = int(np.prod(sizes))
    if len(devices) < need:
        raise ValueError(f"need {need} devices for mesh {list(axes)}, have {len(devices)}")
    dev = np.empty(need, dtype=object)
    dev[:] = devices[:need]
    return Mesh(dev.reshape(sizes), tuple(names))


def graph_mesh(n_devices: Optional[int] = None, devices: Optional[list] = None) -> Mesh:
    """A ``gp`` mesh of ``n_devices`` shards over ``devices`` (default: the
    cards, one shard each)."""
    devices = cards() if devices is None else list(devices)
    return make_mesh([("gp", n_devices or len(devices))], devices)


def serving_mesh(dp: int, gp: int, devices: Optional[list] = None) -> Mesh:
    """(dp, gp) mesh for serving scale-out: the index is sharded over ``gp``
    and replicated over ``dp``; the query batch splits over ``dp``, so
    throughput scales with dp while each query still searches the whole
    gp-sharded graph."""
    return make_mesh([("dp", dp), ("gp", gp)], devices)


def place_row_shards(n: int, s: int, hosts: Dict[torch.device, List[int]], upload) -> Dict[tuple, tuple]:
    """Block-partitioned rows on their devices: shard ``j`` holds rows ``j s
    .. (j + 1) s`` of an ``n``-row array (fewer, or none, at its end), and
    ``hosts`` maps each device to the shards it holds. ``upload(dev, lo,
    hi)`` -> a tuple of tensors of rows ``lo .. hi`` on ``dev``; the
    neighbouring shards of one device share one upload and are row slices
    of it -> {(device, j): that shard's tuple of row slices}."""
    out = {}
    for dev, js in hosts.items():
        runs = [[js[0]]]
        for j in js[1:]:
            if j == runs[-1][-1] + 1:
                runs[-1].append(j)
            else:
                runs.append([j])
        for run in runs:
            lo = min(n, run[0] * s)
            block = upload(dev, lo, min(n, (run[-1] + 1) * s))
            for j in run:
                a, b = min(n, j * s) - lo, min(n, (j + 1) * s) - lo
                out[(dev, j)] = tuple(t[a:b] for t in block)
    return out


def psum(parts: Sequence[torch.Tensor], dest: torch.device) -> torch.Tensor:
    """The sum of the shards' contributions, on ``dest``, added in shard
    order. Differentiable: autograd runs back through the copies."""
    total = parts[0].to(dest)
    for p in parts[1:]:
        total = total + p.to(dest)
    return total


def ppermute(parts: Sequence[torch.Tensor], devices: Sequence[torch.device], shift: int = 1) -> List[torch.Tensor]:
    """Rotate a sharded array around its ring: shard ``i`` receives what
    shard ``i - shift`` held, on its own device (no copy where both shards
    share one)."""
    n = len(parts)
    return [parts[(i - shift) % n].to(devices[i]) for i in range(n)]
