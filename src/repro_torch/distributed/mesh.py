"""The port's device mesh: named axes, their sizes, and, in a rank
process, this rank's coordinates and process groups.

The sharding rules (:mod:`.sharding`) need only axis names and sizes, so a
:class:`Mesh` built from them alone holds nothing else and needs no
process group: the spec tests run it at 256 and 512 ranks.  A mesh
built by :meth:`Mesh.attach` inside an initialised ``torch.distributed``
world also carries a ``torch.distributed.device_mesh.DeviceMesh`` (one
process group per axis), a group for each larger set of axes the model
code reduces over, and this rank's coordinates.  Ranks are laid out in
row-major order over the axes, as the reference's ``make_mesh`` lays out
devices: rank = sum(coord[a] * stride[a]).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

AxisEntry = Union[None, str, Tuple[str, ...]]


class Mesh:
    """Named axes and sizes (``shape``, in order), plus, when attached to
    a process group, ``coords`` of this rank and a group per set of axes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.size = math.prod(self.shape.values())
        self.coords: Optional[Dict[str, int]] = None
        self.rank: Optional[int] = None
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}

    @classmethod
    def attach(cls, shape: Sequence[int], axis_names: Sequence[str],
               device_type: str) -> "Mesh":
        """The mesh over the initialised world (whose size must be the
        mesh's), with this rank's coordinates.  Every rank must call it, in
        the same order as any other group creation: it creates the
        ``DeviceMesh``'s per-axis groups and one group for every set of two
        or more axes."""
        from torch.distributed.device_mesh import DeviceMesh
        mesh = cls(shape, axis_names)
        world = dist.get_world_size()
        if world != mesh.size:
            raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks, the "
                             f"world has {world}")
        mesh.rank = dist.get_rank()
        mesh.coords = mesh.coords_of(mesh.rank)
        ranks = torch.arange(mesh.size).reshape(tuple(mesh.shape.values()))
        mesh.device_mesh = DeviceMesh(device_type, ranks,
                                      mesh_dim_names=mesh.axis_names)
        for name in mesh.axis_names:
            mesh._groups[(name,)] = mesh.device_mesh.get_group(name)
        for n in range(2, len(mesh.axis_names) + 1):
            for axes in itertools.combinations(mesh.axis_names, n):
                if n == len(mesh.axis_names):
                    mesh._groups[axes] = dist.group.WORLD
                    continue
                for members in mesh._partition(axes):
                    group = dist.new_group(members)
                    if mesh.rank in members:
                        mesh._groups[axes] = group
        return mesh

    # -- geometry ---------------------------------------------------------------
    def axis_size(self, entry: AxisEntry) -> int:
        if entry is None:
            return 1
        if isinstance(entry, (tuple, list)):
            return math.prod(self.shape[e] for e in entry)
        return self.shape[entry]

    def coords_of(self, rank: int) -> Dict[str, int]:
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def rank_of(self, coords: Dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            tuple(coords[a] for a in self.axis_names),
            tuple(self.shape.values())))

    def index(self, entry: AxisEntry,
              coords: Optional[Dict[str, int]] = None) -> int:
        """This rank's (or ``coords``') position along ``entry``, one axis
        or several flattened in order (the first the slowest)."""
        coords = self.coords if coords is None else coords
        if entry is None:
            return 0
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        pos = 0
        for a in axes:
            pos = pos * self.shape[a] + coords[a]
        return pos

    def _partition(self, axes: Tuple[str, ...]):
        """The rank sets that share every coordinate outside ``axes``."""
        others = [a for a in self.axis_names if a not in axes]
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = dict(zip(others, fixed))
            members = []
            for moving in itertools.product(*(range(self.shape[a])
                                              for a in axes)):
                members.append(self.rank_of({**base,
                                             **dict(zip(axes, moving))}))
            yield sorted(members)

    def group(self, entry: AxisEntry):
        """This rank's process group over ``entry`` (an axis or a tuple)."""
        if self.coords is None:
            raise RuntimeError("an abstract mesh has no process groups")
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        axes = tuple(a for a in self.axis_names if a in axes)
        return self._groups[axes]

    def peer(self, axis: str, step: int) -> int:
        """The global rank ``step`` places along ``axis`` from this one
        (cyclic)."""
        coords = dict(self.coords)
        coords[axis] = (coords[axis] + step) % self.shape[axis]
        return self.rank_of(coords)

    def __repr__(self) -> str:
        where = "" if self.coords is None else f", coords={self.coords}"
        return f"Mesh({self.shape}{where})"
