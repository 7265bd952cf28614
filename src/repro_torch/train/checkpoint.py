"""Checkpointing with async save.

Layout, as the reference's: ``<dir>/step_<N>/`` holds one ``.npy`` per
tree leaf (path-encoded filename) + ``manifest.json`` (each leaf's key,
shape and dtype, the step and ``extra``).  ``latest`` is an atomic pointer
file.  numpy has no bfloat16, so a bf16 leaf (``mu_dtype=bfloat16``) is
stored as its raw 16-bit pattern and the manifest gives its dtype.

``restore`` places each leaf on the template leaf's device, so a caller
picks the device through the template it builds.

Under a mesh every rank holds only its shard of a leaf, and a save writes
the same files as a one-device save: one ``.npy`` of the *global* leaf
each.  ``save(..., layout=fn)`` takes ``fn(key, leaf)`` -> (the global
shape, the rank's ``Index`` of ``distributed/sharding.py``); rank 0 creates
every file (``np.lib.format.open_memmap``), each rank writes its block into
it, so no rank gathers the model, and rank 0 then writes the manifest and
moves ``latest``.  Such a save is synchronous (its barriers are
collectives of the world).  ``restore(..., sharding_fn=fn)`` is the
reference's elastic restore onto another mesh: ``fn(key, template_leaf)``
returns the Index of the rank's part on the *new* mesh (or None for the
whole leaf), and the rank reads only that part (``np.load(...,
mmap_mode="r")``).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .tree import tree_leaves_with_path, tree_map_with_path

#: per dimension, the indices a rank holds (None: all of them)
Index = Tuple[Optional[torch.Tensor], ...]

#: dtypes numpy cannot hold, stored as the raw bits of this integer type
_RAW_BITS = {torch.bfloat16: torch.int16}
_DTYPES = {str(d).replace("torch.", ""): d for d in (
    torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.int8,
    torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool)}


def _fname(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in _RAW_BITS:
        t = t.view(_RAW_BITS[t.dtype])
    return t.numpy()


def _from_host(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(dtype) if dtype in _RAW_BITS else t


def _region(index: Optional[Index], shape: Sequence[int]):
    """A numpy index of an array of ``shape`` for ``index``: slices where a
    dimension is whole or a run of consecutive indices, an open mesh of
    arrays where more than one is neither."""
    index = (None,) * len(shape) if index is None else tuple(index)
    parts: List[Any] = []
    for ix, n in zip(index, shape):
        if ix is None:
            parts.append(slice(0, n))
            continue
        ix = ix.cpu().numpy()
        if len(ix) and np.array_equal(ix, np.arange(ix[0], ix[0] + len(ix))):
            parts.append(slice(int(ix[0]), int(ix[0]) + len(ix)))
        else:
            parts.append(ix)
    if sum(not isinstance(p, slice) for p in parts) > 1:
        return np.ix_(*[np.arange(p.start, p.stop) if isinstance(p, slice)
                        else p for p in parts])
    return tuple(parts)


def _leaf_meta(key: str, shape: Sequence[int], dtype: torch.dtype) -> Dict:
    return {"key": key, "shape": [int(n) for n in shape],
            "dtype": str(dtype).replace("torch.", "")}


class Checkpointer:
    """Save/restore trees of tensors."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        # guards _pending only; never held across a blocking .result()
        # (hand-over-hand, see wait())
        self._lock = threading.Lock()
        self._pending: Optional[concurrent.futures.Future] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None, *,
             layout: Optional[Callable[[str, torch.Tensor],
                                       Tuple[Sequence[int], Index]]] = None
             ) -> None:
        """Snapshot to host memory synchronously, write asynchronously.
        ``layout``: under a mesh, ``layout(key, leaf)`` -> (global shape,
        the rank's Index); every rank calls ``save`` and writes its
        blocks, synchronously."""
        leaves = tree_leaves_with_path(tree)
        if layout is not None:
            self._save_sharded(step, leaves, extra, layout)
            return
        host = [(k, _to_host(v)) for k, v in leaves]
        manifest = {
            "step": step,
            "leaves": [_leaf_meta(k, v.shape, v.dtype) for k, v in leaves],
            "extra": extra or {},
        }
        self.wait()
        if self.async_save:
            with self._lock:
                self._pending = self._pool.submit(self._write, step, host,
                                                  manifest)
        else:
            self._write(step, host, manifest)

    def _save_sharded(self, step: int, leaves, extra: Optional[Dict],
                      layout) -> None:
        self.wait()
        d = os.path.join(self.directory, f"step_{step:08d}")
        tmp = d + ".tmp"
        places = [(k, v, *layout(k, v)) for k, v in leaves]
        first = dist.get_rank() == 0
        if first:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for k, v, shape, _ in places:
                np.lib.format.open_memmap(
                    os.path.join(tmp, _fname(k)), mode="w+",
                    dtype=_to_host(v.reshape(-1)[:0]).dtype,
                    shape=tuple(shape))
        dist.barrier()
        for k, v, shape, index in places:
            out = np.load(os.path.join(tmp, _fname(k)), mmap_mode="r+")
            out[_region(index, shape)] = _to_host(v)
            del out         # written back by the page cache, as np.save's
        dist.barrier()
        if first:
            manifest = {"step": step,
                        "leaves": [_leaf_meta(k, shape, v.dtype)
                                   for k, v, shape, _ in places],
                        "extra": extra or {}}
            self._write(step, [], manifest)
        dist.barrier()

    def _write(self, step: int, host, manifest) -> None:
        d = os.path.join(self.directory, f"step_{step:08d}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for k, v in host:
            np.save(os.path.join(tmp, _fname(k)), v)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        with open(os.path.join(self.directory, "latest.tmp"), "w") as f:
            f.write(os.path.basename(d))
        os.replace(os.path.join(self.directory, "latest.tmp"),
                   os.path.join(self.directory, "latest"))
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        # hand-over-hand: swap the future out under the lock, block on it
        # with the lock RELEASED so a concurrent save() can't deadlock
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                sharding_fn: Optional[Callable[[str, Any],
                                               Optional[Index]]] = None
                ) -> Tuple[Any, int, Dict]:
        """Restore into the structure of ``template``: each leaf in its
        saved dtype, on the template leaf's device.  ``sharding_fn(key,
        template_leaf)`` may return the Index of the part this rank holds
        (the elastic restore onto another mesh; None: the whole leaf),
        and only that part is read.  Returns (tree, step, extra)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = {leaf["key"]: _DTYPES[leaf["dtype"]]
                  for leaf in manifest["leaves"]}

        def load(key: str, tmpl: torch.Tensor) -> torch.Tensor:
            arr = np.load(os.path.join(d, _fname(key)), mmap_mode="r")
            index = sharding_fn(key, tmpl) if sharding_fn else None
            t = _from_host(np.array(arr[_region(index, arr.shape)]),
                           dtypes[key])
            if tuple(t.shape) != tuple(tmpl.shape):
                raise ValueError(f"{key}: saved shape {tuple(t.shape)}, "
                                 f"template {tuple(tmpl.shape)}")
            return t.to(tmpl.device)
        return tree_map_with_path(load, template), step, manifest["extra"]
