"""The port's device mesh: named axes over places.

The JAX package passes a ``jax.sharding.Mesh`` to its multi-device entry
points.  The port's :class:`Mesh` is the same idea without a runtime behind
it: an n-d array of places (``torch.device`` s) with one name per axis.
Places may repeat one device.  Such virtual places are what the JAX tests
get from 8 virtual CPU devices, and they let one card (or the CPU) run a
mesh of 4 or 8.

What the axes mean is the callers':

* ``"data"`` partitions a batch of scenes over places (``parallel/sweep.
  shard_batch``): each place runs its scene group through the batched
  loop, on its own device;
* ``"bots"`` splits each scene's table over a ring of shards
  (``parallel/ring.py``).  The port runs the ring of one data place on one
  device (``LocalRing``), so the places along it must share one.

Nothing here starts a process group: ``torch.distributed``'s own device
mesh needs one even on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from .ring import _device


class Mesh:
    """``places``: a nested sequence (or array) of devices or device
    strings, one axis per name in ``axis_names``; a flat sequence with one
    name is a 1-d mesh.  Each place is resolved as the ring resolves a
    device (``"cuda"`` is the current card and needs one)."""

    def __init__(self, places, axis_names=("data",)):
        arr = np.array(places, dtype=object)
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names) or arr.size == 0:
            raise ValueError(
                f"{arr.ndim}-d places of shape {arr.shape} for axes {self.axis_names}"
            )
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx, place in np.ndenumerate(arr):
            self.devices[idx] = _device(place)

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str) -> list:
        """The device of each index along ``axis``: the one device that its
        slice of the other axes sits on (a data place's ring of shards);
        raises ValueError when a slice spans devices."""
        i = self.axis_names.index(axis)
        rows = np.moveaxis(self.devices, i, 0).reshape(self.devices.shape[i], -1)
        out = []
        for row in rows:
            if len(set(row)) != 1:
                raise ValueError(
                    f"the places of one {axis!r} index span devices {sorted(map(str, set(row)))}; "
                    "the port's ring holds its shards on one device"
                )
            out.append(row[0])
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, places {[str(d) for d in self.devices.reshape(-1)]})"


def default_mesh(axis: str = "data", device="cuda") -> Mesh:
    """A 1-d mesh over every visible card (``torch.cuda.device_count()``)
    for ``"cuda"``, or over the one CPU for ``"cpu"``."""
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    if kind == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))
    return Mesh([device], (axis,))
