"""Micro-batch stream framing for the executor, over a pluggable clock.

The executor's pacing, latency accounting, retry backoff, watchdog and
load-shedding decisions all read ONE clock object.  :class:`WallClock` is
the real thing; :class:`VirtualClock` advances only when slept on, which
makes whole chaos replays deterministic (bit-identical timelines across
runs) and fast (no real sleeping) — the mode the chaos tests run in.

A copy of the reference's ``runtime/stream.py`` with torch tensors:
:class:`SyntheticSource` draws the reference's numpy stream from the same
seed (so payloads, values and, under a :class:`VirtualClock`, ``created``
times are bit-equal to the reference's) and puts each frame on an explicit
device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..models.common import DeviceLike, resolve_device


class WallClock:
    """Real time: ``perf_counter`` + ``time.sleep``."""

    virtual = False

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock:
    """Deterministic simulated time: ``sleep`` advances, nothing blocks."""

    virtual = True

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def now(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self.t += float(seconds)


@dataclasses.dataclass
class MicroBatch:
    """A frame of tuples moving through the dataflow."""

    seq: int                         # frame sequence number
    arrays: Dict[str, torch.Tensor]  # leading axis = tuple axis
    created: float                   # clock arrival time at the source (s)

    @property
    def size(self) -> int:
        return next(iter(self.arrays.values())).shape[0]


class SyntheticSource:
    """Constant-rate synthetic tuple source (§8.3: single opaque field).

    Emits micro-batches of ``batch`` tuples on ``device`` (CUDA unless the
    caller names another; without a card that raises); the admission
    times honour the requested rate *on the supplied clock* so end-to-end
    latency measurements are meaningful under both wall and virtual time.
    """

    def __init__(self, rate: float, batch: int = 32, payload_len: int = 256,
                 seed: int = 0, clock: Optional[WallClock] = None,
                 start_seq: int = 0, device: DeviceLike = None):
        self.rate = rate
        self.batch = batch
        self.payload_len = payload_len
        self.rng = np.random.default_rng(seed)
        self.clock = clock if clock is not None else WallClock()
        self.device = resolve_device(device)
        self._seq = int(start_seq)

    def frames(self, duration: float = 0.0, *,
               n_frames: Optional[int] = None) -> Iterator[MicroBatch]:
        if n_frames is None:
            n_frames = max(1, int(self.rate * duration / self.batch))
        interval = self.batch / self.rate
        start = self.clock.now()
        for i in range(n_frames):
            sched = start + i * interval
            now = self.clock.now()
            if sched > now:
                self.clock.sleep(sched - now)
            payload = self.rng.integers(32, 127, size=(self.batch, self.payload_len),
                                        dtype=np.uint8)
            value = self.rng.random(self.batch, dtype=np.float32)
            yield MicroBatch(
                seq=self._seq,
                arrays={"payload": torch.from_numpy(payload).to(self.device),
                        "value": torch.from_numpy(value).to(self.device)},
                created=max(sched, self.clock.now()),
            )
            self._seq += 1
