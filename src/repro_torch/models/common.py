"""Shared model plumbing: the execution environment and the initializers.

Models are plain functions over nested dicts of tensors.  ``Env`` carries
where and in what precision they run, how the training forward recomputes
each layer in its backward, and the distribution context: the mesh, the
batch axes and the tensor/expert-parallel axis, as the reference's ``Env``
does.  Under a mesh each rank holds only its shard of the weights and
caches (``distributed/sharding.py``) and the model code issues its
collectives through ``distributed/collectives.py``; a training forward
gathers each layer's weights over the batch axes inside the layer's
checkpointed body (:func:`fsdp_gather`), so the backward gathers them
again instead of keeping whole layers alive.  Which attention runs is
decided by the tensors' device (the CUDA kernel on the card, its plain
version on the CPU and, in a dry run, on meta tensors), so there is no
kernel switch.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.utils.checkpoint

from ..distributed.collectives import gather
from ..distributed.mesh import Mesh
from ..distributed.sharding import (Index, fsdp_dim, local_cache_index,
                                    local_index)

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
    #: activation checkpointing of each layer body in the training forward
    remat: bool = True
    mesh: Optional[Mesh] = None
    batch_axes: Tuple[str, ...] = ()     # e.g. ("pod", "data")
    tp_axis: Optional[str] = None        # tensor/expert-parallel axis
    #: under a tp axis that divides the sequence, the training forward keeps
    #: the residual stream split over tp along the sequence (Megatron's
    #: sequence parallelism): a reduce-scatter in place of each row-parallel
    #: all-reduce, an all-gather before each column-parallel input
    seq_shard_activations: bool = False
    #: query chunk of the plain attention (0: whole), each chunk
    #: checkpointed: the path the flash kernel does not take
    attn_q_chunk: int = 0
    #: what a checkpointed body keeps for its backward: "nothing" (the
    #: reference's default: recompute the whole body) or "dots" (keep the
    #: outputs of matrix products without batch dimensions, the
    #: reference's ``dots_with_no_batch_dims_saveable``)
    remat_policy: str = "nothing"

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


def default_env(device: DeviceLike = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> Env:
    return Env(resolve_device(device), compute_dtype)


#: the matrix products without batch dimensions that ``remat_policy="dots"``
#: keeps (``F.linear`` reaches one of these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_save_dots)


def checkpointed(env: Env, body: Callable, *args):
    """``body(*args)`` checkpointed under ``env.remat_policy``: "nothing"
    keeps only the inputs (the reference's ``nothing_saveable``), "dots"
    also the outputs of ``mm``/``addmm``."""
    if env.remat_policy == "dots":
        return torch.utils.checkpoint.checkpoint(
            body, *args, use_reentrant=False, context_fn=_dots_context)
    if env.remat_policy != "nothing":
        raise ValueError(f"remat_policy is nothing or dots, not "
                         f"{env.remat_policy!r}")
    return torch.utils.checkpoint.checkpoint(body, *args,
                                             use_reentrant=False)


def layer_call(env: Env, body: Callable, *args):
    """``body(*args)``, checkpointed when ``env.remat`` and grad is on
    (:func:`checkpointed`): the backward runs the body once more, its
    weight gathers included."""
    if env.remat and torch.is_grad_enabled():
        return checkpointed(env, body, *args)
    return body(*args)


@functools.lru_cache(maxsize=None)
def full_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Path (keys joined by ``/``) -> full shape of every leaf of ``cfg``'s
    params, from an init on meta tensors (shapes only)."""
    from .api import get_model
    out: Dict[str, Tuple[int, ...]] = {}

    def walk(tree, prefix: str) -> None:
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}")
        else:
            out[prefix] = tuple(tree.shape)
    walk(get_model(cfg).init(torch.Generator(), device="meta"), "")
    return out


@functools.lru_cache(maxsize=None)
def _fsdp_dims(cfg, mesh: Mesh, batch_axes: Tuple[str, ...]
               ) -> Dict[str, Tuple[int, int]]:
    """Path -> (dimension, full size) of every leaf training splits over
    the batch axes."""
    out: Dict[str, Tuple[int, int]] = {}
    for path, shape in full_shapes(cfg).items():
        dim = fsdp_dim(mesh, batch_axes, path, shape)
        if dim is not None:
            out[path] = (dim, shape[dim])
    return out


def fsdp_gather(env: Env, cfg, tree, prefix: str, skip: Sequence[str] = ()):
    """``tree`` (the params at ``prefix``) with every leaf that training
    splits over the batch axes all-gathered whole (``collectives.gather``:
    the backward reduce-scatters its gradient, the batch axes' sum).  A
    leaf already whole (serving's layout, one batch rank) is as it is;
    the leaves at the paths in ``skip`` (relative to ``prefix``) are left
    out."""
    if env.mesh is None or env.dp == 1:
        return tree
    dims = _fsdp_dims(cfg, env.mesh, tuple(env.batch_axes))
    group = env.mesh.group(tuple(env.batch_axes))

    def walk(node, rel: str):
        path = f"{prefix}/{rel}" if prefix and rel else (prefix or rel)
        if isinstance(node, dict):
            return {k: walk(v, f"{rel}/{k}" if rel else k)
                    for k, v in node.items()
                    if (f"{rel}/{k}" if rel else k) not in skip}
        if isinstance(node, list):
            return [walk(v, f"{rel}/{i}" if rel else str(i))
                    for i, v in enumerate(node)]
        where = dims.get(path)
        if where is None or node.shape[where[0]] == where[1]:
            return node
        return gather(node, group, where[0])
    return walk(tree, "")


def shard_kw(cfg, env: Optional[Env], device: torch.device,
             dtype: torch.dtype, fsdp: bool = False) -> Dict[str, Any]:
    """An initializer's keywords: under a mesh, with the rank's
    ``local_index`` of every leaf (:func:`leaf`); ``fsdp``: the
    training layout (also split over the batch axes)."""
    kw: Dict[str, Any] = dict(device=device, dtype=dtype)
    if env is not None and env.mesh is not None:
        batch = tuple(env.batch_axes) if fsdp else ()
        kw.update(prefix="", shard=lambda path, shape: local_index(
            cfg, env.mesh, path, shape, batch_axes=batch))
    return kw


def local_zeros(cfg, env: Env, name: str, shape, dtype) -> torch.Tensor:
    """Zeros of this rank's part of the cache entry ``name`` of full
    ``shape`` (``sharding.local_cache_index``)."""
    index = local_cache_index(cfg, env, name, shape)
    return torch.zeros(_local_shape(shape, index), dtype=dtype,
                       device=env.device)


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
