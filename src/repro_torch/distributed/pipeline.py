"""Pipeline parallelism: GPipe-style microbatch pipelining over a "pipe"
mesh axis (the reference's ``distributed/pipeline.py``).

The layer stack is split into ``n_stages`` contiguous groups; stage s's
params live only on pipe-rank s.  Microbatches stream through: at step t,
rank s processes microbatch (t - s) and passes its activations to rank s+1
by send/recv (the reference's ``collective_permute``), the classic skew
schedule with (n_stages - 1) bubble steps on each side.  The reference's
``lax.scan`` over the steps is a Python loop here, its ``ppermute`` a
:func:`~repro_torch.distributed.collectives.permute` around the pipe ring,
its final ``psum`` an all-reduce over the pipe group.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..train.tree import tree_map
from .collectives import all_reduce, permute
from .mesh import Mesh

Params = Any


def split_stages(stacked_params: Params, n_stages: int) -> Params:
    """Reshape (L, ...) stacked layer params to (n_stages, L/n_stages, ...)."""
    def one(x):
        L = x.shape[0]
        assert L % n_stages == 0, f"layers {L} not divisible by {n_stages}"
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])
    return tree_map(one, stacked_params)


def gpipe(layer_fn: Callable[[Params, torch.Tensor], torch.Tensor],
          mesh: Mesh, *, pipe_axis: str, n_microbatches: int):
    """Build a pipelined apply: ``f(stage_params, x) -> y`` for this rank.

    ``layer_fn(stage_params, x)`` applies ONE stage's layer group to a
    microbatch.  ``stage_params`` leaves have a leading stage axis: all
    ``n_stages`` stages (this rank takes its own) or only this rank's (a
    leading 1).  ``x`` is (n_microbatches, mb, ...), the same on every rank
    of the pipe (each rank picks what it needs by schedule position).

    Returns y with the same layout as x, on every rank.
    """
    n_stages = mesh.shape[pipe_axis]
    group = mesh.group(pipe_axis)

    def pipelined(stage_params, x):
        rank = mesh.coords[pipe_axis]
        my_params = tree_map(
            lambda p: p[0] if p.shape[0] == 1 else p[rank], stage_params)
        n_steps = n_microbatches + n_stages - 1
        outputs = torch.zeros_like(x)
        inflight = torch.zeros_like(x[0])
        nxt, prv = mesh.peer(pipe_axis, 1), mesh.peer(pipe_axis, -1)
        for t in range(n_steps):
            # rank 0 injects microbatch t; others take the permuted input
            cur = x[min(t, n_microbatches - 1)] if rank == 0 else inflight
            # process if this rank has live work: 0 <= t - rank < n_mb
            live = rank <= t < rank + n_microbatches
            out = layer_fn(my_params, cur) if live else cur
            # last stage stores its finished microbatch
            if live and rank == n_stages - 1:
                outputs[t - rank] = out
            # pass activations downstream
            inflight = permute(out, send_to=nxt, recv_from=prv, group=group)
        # only the last stage holds real outputs (zeros elsewhere): an
        # all-reduce over the pipe axis replicates them on every rank
        return all_reduce(outputs, group)

    return pipelined
