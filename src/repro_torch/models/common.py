"""Shared model plumbing: the execution environment and the initializers.

Models are plain functions over nested dicts of tensors.  ``Env`` carries
where and in what precision they run, whether the training forward
recomputes each layer in its backward, and the distribution context: the
mesh, the batch axes and the tensor/expert-parallel axis, as the
reference's ``Env`` does.  Under a mesh each rank holds only its shard of
the weights and caches (``distributed/sharding.py``) and the model code
issues its collectives through ``distributed/collectives.py``.  Which
attention runs is decided by the tensors' device (the CUDA kernel on the
card, its plain version on the CPU), so there is no kernel switch.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.utils.checkpoint

from ..distributed.mesh import Mesh
from ..distributed.sharding import Index

Params = Dict[str, Any]
DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Asking for CUDA (explicitly or by default) on a machine
    without it raises rather than running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Env:
    """Execution context threaded through model code."""

    device: torch.device
    compute_dtype: torch.dtype = torch.bfloat16
    #: activation checkpointing of each layer body in the training forward,
    #: with the reference's default policy "nothing": the backward recomputes
    #: the whole body from its input
    remat: bool = True
    mesh: Optional[Mesh] = None
    batch_axes: Tuple[str, ...] = ()     # e.g. ("pod", "data")
    tp_axis: Optional[str] = None        # tensor/expert-parallel axis

    @property
    def dp(self) -> int:
        if self.mesh is None or not self.batch_axes:
            return 1
        return self.mesh.axis_size(tuple(self.batch_axes))

    @property
    def tp(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.mesh.shape[self.tp_axis]

    def tp_entry_if_divisible(self, dim: int):
        """tp axis entry only when it divides ``dim`` (e.g. GQA kv heads
        smaller than the tp width must replicate, not flip-flop shard)."""
        if self.tp_axis is None or self.mesh is None:
            return None
        return self.tp_axis if dim % self.tp == 0 else None

    def tp_shards(self, dim: int) -> bool:
        """Whether a dimension of full size ``dim`` (heads, hidden, vocab,
        experts) is split over the tp axis: under a mesh with one, exactly
        when it divides, a width of 1 included (its collectives then run
        on a group of one)."""
        return self.tp_entry_if_divisible(dim) is not None

    @property
    def tp_rank(self) -> int:
        return 0 if self.tp_axis is None or self.mesh is None else \
            self.mesh.coords[self.tp_axis]

    @property
    def tp_group(self):
        return self.mesh.group(self.tp_axis)


def check_unsharded_training(env: Env) -> None:
    """The training forward is not sharded yet (ROADMAP.md Queue 1, item
    9): the port's collectives carry no gradient, so a forward under a
    mesh with grad on is refused rather than differentiated wrongly."""
    if env.mesh is not None and torch.is_grad_enabled():
        raise NotImplementedError(
            "training under a mesh is not ported yet (ROADMAP.md Queue 1, "
            "item 9); run the forward under torch.no_grad() or without a "
            "mesh")


def default_env(device: DeviceLike = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> Env:
    return Env(resolve_device(device), compute_dtype)


def layer_call(env: Env, body: Callable, *args):
    """``body(*args)``, checkpointed when ``env.remat``: only the layer's
    inputs are kept for the backward, which runs the body once more (the
    reference's ``jax.checkpoint`` with ``nothing_saveable``)."""
    if env.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(body, *args,
                                                 use_reentrant=False)
    return body(*args)


# ---------------------------------------------------------------------------
# Initializers (explicit generator; weights in nn.Linear's (out, in) layout).
# ---------------------------------------------------------------------------

#: the tile a tensor is drawn in: a matrix in tiles of at most TILE x TILE,
#: a stack of three or more axes (experts) one slice of its first axis at a
#: time, a vector whole.  Each tile draws from a generator of its own,
#: seeded from the leaf's seed (one draw of the caller's generator per
#: leaf) and the tile's number, so the tiles of a rank's shard are drawn
#: without the rest, and equal the same tiles of the whole tensor; a draw
#: never holds more than a tile in fp32
TILE = 2048


def _tile_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if len(shape) <= 1:
        return shape
    if len(shape) == 2:
        return (min(TILE, shape[0]), min(TILE, shape[1]))
    return (1,) + shape[1:]


def _tile_seed(seed: int, tile: int) -> int:
    return (seed + 0x9E3779B97F4A7C15 * (tile + 1)) % (1 << 63)


#: a leaf's index (``distributed/sharding.py`` ``local_index``) given its
#: full shape
Where = Callable[[Tuple[int, ...]], Index]


def _local_shape(shape: Tuple[int, ...], index: Index) -> Tuple[int, ...]:
    return tuple(n if ix is None else len(ix) for n, ix in zip(shape, index))


def _draw(gen: torch.Generator, shape: Sequence[int],
          fill: Callable[[torch.Tensor, torch.Generator], torch.Tensor], *,
          device: torch.device, dtype: torch.dtype,
          where: Optional[Where] = None) -> torch.Tensor:
    """``fill(t, g)`` fills an fp32 tile ``t`` from generator ``g``; the
    leaf of full ``shape`` is drawn tile by tile (:data:`TILE`) and cast to
    ``dtype``, keeping only the part ``where`` selects."""
    shape = tuple(shape)
    index = where(shape) if where is not None else (None,) * len(shape)
    seed = int(torch.randint(1 << 62, (1,), generator=gen,
                             device=gen.device).item())
    out = torch.empty(_local_shape(shape, index), dtype=dtype, device=device)
    if out.device.type == "meta":          # shapes only (a dry run)
        return out
    sub = torch.Generator(device=device)
    tile = _tile_shape(shape)
    starts = [range(0, n, t) for n, t in zip(shape, tile)]
    for number, corner in enumerate(itertools.product(*starts)):
        src, dst, extent = [], [], []
        for s0, n, t, ix in zip(corner, shape, tile, index):
            end = min(s0 + t, n)
            extent.append(end - s0)
            if ix is None:
                src.append(None)
                dst.append(slice(s0, end))
                continue
            inside = ((ix >= s0) & (ix < end)).nonzero().flatten()
            if len(inside) == 0:
                break
            src.append(ix[inside] - s0)
            # kept indices ascend, so a tile's land in one run
            dst.append(slice(int(inside[0]), int(inside[-1]) + 1))
        else:
            sub.manual_seed(_tile_seed(seed, number))
            t = fill(torch.empty(extent, dtype=torch.float32, device=device),
                     sub)
            for dim, ix in enumerate(src):
                if ix is not None:
                    t = t.index_select(dim, ix.to(device))
            out[tuple(dst)] = t.to(dtype)
    return out


def dense_init(gen: torch.Generator, shape: Sequence[int], *,
               device: torch.device, dtype: torch.dtype = torch.float32,
               in_axis: int = -1, where: Optional[Where] = None
               ) -> torch.Tensor:
    """Truncated-normal fan-in init (1/sqrt(fan_in)), as the reference's
    ``dense_init``; drawn in fp32, then cast."""
    scale = shape[in_axis] ** -0.5

    def fill(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
        torch.nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=g)
        return t * scale
    return _draw(gen, shape, fill, device=device, dtype=dtype, where=where)


def embed_init(gen: torch.Generator, shape: Sequence[int], *,
               device: torch.device, dtype: torch.dtype = torch.float32,
               where: Optional[Where] = None) -> torch.Tensor:
    return _draw(gen, shape, lambda t, g: t.normal_(generator=g) * 0.02,
                 device=device, dtype=dtype, where=where)


def const(value: torch.Tensor, *, device: torch.device, dtype: torch.dtype,
          where: Optional[Where] = None) -> torch.Tensor:
    """A leaf computed whole (zeros, ones, a ``linspace``), cut to the part
    ``where`` selects."""
    if where is not None:
        for dim, ix in enumerate(where(tuple(value.shape))):
            if ix is not None:
                value = value.index_select(dim, ix.to(value.device))
    return value.to(device=device, dtype=dtype)


def zeros(shape: Sequence[int], *, device: torch.device,
          dtype: torch.dtype = torch.float32,
          where: Optional[Where] = None) -> torch.Tensor:
    shape = tuple(shape)
    index = where(shape) if where is not None else (None,) * len(shape)
    return torch.zeros(_local_shape(shape, index), device=device, dtype=dtype)


def ones(shape: Sequence[int], *, device: torch.device,
         dtype: torch.dtype = torch.float32,
         where: Optional[Where] = None) -> torch.Tensor:
    shape = tuple(shape)
    index = where(shape) if where is not None else (None,) * len(shape)
    return torch.ones(_local_shape(shape, index), device=device, dtype=dtype)


def leaf(kw: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The keywords of an initializer for the leaf ``name`` under ``kw``:
    ``kw`` holds ``device`` and ``dtype`` and, when a rank draws only its
    shard, ``shard`` (``shard(path, shape)`` -> the leaf's index) and
    ``prefix``, the path of the dict being drawn."""
    out = {"device": kw["device"], "dtype": kw["dtype"]}
    shard = kw.get("shard")
    if shard is not None:
        path = f"{kw['prefix']}/{name}" if kw.get("prefix") else name
        out["where"] = lambda shape: shard(path, shape)
    return out


def under(kw: Dict[str, Any], name: str) -> Dict[str, Any]:
    """``kw`` for the dict ``name`` inside the one ``kw`` draws."""
    if kw.get("shard") is None:
        return kw
    return {**kw, "prefix": f"{kw['prefix']}/{name}" if kw.get("prefix")
            else name}
