"""Start ``R`` rank processes on this host and collect what each returns.

The one spawn helper of the port: ``launch/serve.py --tp R``,
``chip_smoke.py``'s sharded phase and the multi-rank tests all start their
ranks here.  Each rank is a ``torch.multiprocessing`` process started with
``spawn``.  It joins a local rendezvous (a file store in a fresh directory),
over NCCL with one card per rank (``torch.cuda.set_device(rank)`` before
the group is made) or over gloo on the CPU, calls ``fn(rank, *args)``, and
hands its return value back through a file beside the store.  There is no
fallback: asking for CUDA without enough cards raises, and a rank that
fails or outlives ``timeout`` fails the whole call (every rank is stopped).
"""

from __future__ import annotations

import datetime
import os
import pathlib
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, nprocs: int, device_type: str,
               workdir: str, timeout: float, threads: Optional[int],
               args: Sequence[Any]) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        # ranks of one host talk over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"file://{workdir}/rendezvous", rank=rank,
        world_size=nprocs, timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *, args: Sequence[Any] = (),
          device: str = "cuda", timeout: float = 600.0,
          threads: Optional[int] = None,
          workdir: Optional[str] = None) -> List[Any]:
    """``[fn(rank, *args) for rank in range(nprocs)]``, each in a rank
    process of one world.  ``device``: ``"cuda"`` (NCCL, rank r on card r)
    or ``"cpu"`` (gloo).  ``fn`` and ``args`` must pickle (a module-level
    function); what ``fn`` returns should hold CPU tensors.  ``threads``
    sets each rank's ``torch.set_num_threads``; ``workdir`` (default: the
    system's temporary directory) gets a fresh directory for the store."""
    device_type = torch.device(device).type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        if torch.cuda.device_count() < nprocs:
            raise RuntimeError(f"{nprocs} ranks need {nprocs} cards, "
                               f"{torch.cuda.device_count()} are visible")
    elif device_type != "cpu":
        raise ValueError(f"ranks run on cuda or cpu, not {device}")
    root = pathlib.Path(tempfile.mkdtemp(prefix="ranks-", dir=workdir))
    ctx = mp.start_processes(
        _rank_main, args=(fn, nprocs, device_type, str(root), timeout,
                          threads, tuple(args)),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within "
                                   f"{timeout:.0f} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(nprocs)]
