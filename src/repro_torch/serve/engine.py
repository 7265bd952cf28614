"""Continuous-batching serving engine.

Slot-based engine: ``max_batch`` sequence slots share one decode cache on
the device; requests prefill into a free slot and then ride the batched
decode step.  Same slots, admission, prefill-one, batched decode and finish
rules as the reference engine (``repro/serve/engine.py``).

The split of GPUs between prefill and decode pools is decided by the
paper's MBA/SAM (see planner.py); this engine is the execution layer.

Each step opens ``repro_torch.obs`` spans (recorded only while tracing is
enabled): ``serve.step``; one ``serve.admit`` an admission (``prompt_len``,
``queued_s``: ``submit`` to admission) around ``serve.prefill``,
``serve.insert`` and ``serve.first_token``; and ``serve.decode``
(``active``: the slots decoding) around the batched decode step and
``serve.sample``, the host's wait for the chosen tokens.  ``serve.admit``
and ``serve.decode`` span the intervals that ``timings`` records, which
stays the always-on record.

On one CUDA device (no mesh) the batched decode step is captured once, at
construction while every slot is free, as a ``torch.cuda.CUDAGraph`` over
static inputs and the cache, the greedy ``argmax`` included; each tick
uploads the slots' last tokens and positions in place, replays it and
reads the tokens.  The replay runs the same kernels on the same data, so
it changes no arithmetic; what it removes is the host issuing each of the
step's operations.  The model's ``block.*`` and ``model.logits`` spans
inside the step therefore open only during the capture; ``serve.decode``
and ``serve.sample`` still open every tick.  Elsewhere (the CPU, or a mesh,
whose collectives are not captured) the same step runs eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..models.api import ModelApi
from ..models.common import Env
from ..obs.trace import span as _obs_span

#: decode steps run on a side stream before the capture (lazy set-up of
#: the libraries' handles and workspaces), as ``torch.cuda.graph`` asks
GRAPH_WARMUP = 3


def decode_graphed(env: Env) -> bool:
    """Whether an engine on ``env`` replays its decode step as a CUDA graph:
    on a CUDA device without a mesh (a mesh's collectives run eagerly)."""
    return env.device.type == "cuda" and env.mesh is None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S_prompt,) int32
    max_new_tokens: int
    submitted: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    output: List[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    """The cache is allocated once on ``env.device`` in the compute dtype
    (an SSM's recurrent state stays fp32) and updated in place by prefill
    inserts and decode steps; a captured decode graph holds its addresses.

    ``timings`` holds the host seconds of every prefill (cache insert and
    first token included) and every batched decode step (upload, step or
    replay, token read); each ends in a device-to-host read of the chosen
    tokens, so it covers the device work too."""

    def __init__(self, api: ModelApi, env: Env, params: Any, *,
                 max_batch: int = 8, max_len: int = 512,
                 eos_token: int = -1):
        self.api = api
        self.env = env
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos = eos_token
        self.cache = api.init_cache(max_batch, max_len, env,
                                    dtype=env.compute_dtype)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)       # next write index
        self.slot_budget = np.zeros(max_batch, np.int32)
        self.slot_last_token = np.zeros(max_batch, np.int32)
        self.pending: Deque[Request] = deque()
        self._next_rid = 0
        self.timings: Dict[str, List[float]] = {"prefill": [], "decode": []}
        #: called with each finished request and its slot, while the slot's
        #: cache still holds the request's sequence
        self.on_finish: List[Callable[[Request, int], None]] = []
        # the decode step's inputs, rows (last tokens, positions), and its
        # chosen tokens, resident on the device for the graph to read/write
        self._inputs = torch.zeros((2, max_batch), dtype=torch.long,
                                   device=env.device)
        self._next = torch.zeros(max_batch, dtype=torch.int32,
                                 device=env.device)
        self._graph = self._capture() if decode_graphed(env) else None

    # -- API ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(Request(rid, np.asarray(prompt, np.int32),
                                    max_new_tokens, submitted=time.perf_counter()))
        return rid

    def prefill_batch(self, prompt: np.ndarray) -> Dict[str, torch.Tensor]:
        """The prefill's inputs for one prompt: its tokens (1, S) and, as the
        reference engine passes them, zero stand-ins for the stubbed
        frontends in the compute dtype: whisper's encoder ``frames`` (1,
        encoder_seq, D), phi-3-vision's ``patch_embeds`` (1, min(num_patches,
        S), D)."""
        cfg, dev = self.api.cfg, self.env.device
        batch = {"tokens": torch.as_tensor(prompt[None, :], dtype=torch.long,
                                           device=dev)}
        stub = dict(dtype=self.env.compute_dtype, device=dev)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (1, cfg.encoder_seq, cfg.d_model), **stub)
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (1, min(cfg.num_patches, len(prompt)), cfg.d_model), **stub)
        return batch

    def has_work(self) -> bool:
        return bool(self.pending) or any(r is not None for r in self.slot_req)

    def step(self) -> List[Request]:
        """One engine iteration: admit + prefill one request per free slot,
        then one batched decode step.  Returns finished requests."""
        with _obs_span("serve.step"):
            self._admit()
            return self._decode_tick()

    def run(self, *, max_ticks: int = 10000) -> List[Request]:
        done: List[Request] = []
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            done.extend(self.step())
            ticks += 1
        return done

    # -- internals ---------------------------------------------------------------
    def _admit(self) -> None:
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        while free and self.pending:
            slot = free.pop(0)
            req = self.pending.popleft()
            t0 = time.perf_counter()
            prompt = req.prompt[: self.max_len - req.max_new_tokens - 1]
            with _obs_span("serve.admit", prompt_len=len(prompt),
                           queued_s=t0 - req.submitted):
                with _obs_span("serve.prefill"):
                    logits, cache1 = self.api.prefill(
                        self.env, self.params, self.prefill_batch(prompt),
                        max_len=self.max_len)
                self._insert_cache(slot, cache1)
                with _obs_span("serve.first_token"):
                    next_tok = int(torch.argmax(logits[0, -1]))
                req.first_token_at = time.perf_counter()
            self.timings["prefill"].append(req.first_token_at - t0)
            req.output.append(next_tok)
            self.slot_req[slot] = req
            self.slot_pos[slot] = len(prompt)
            self.slot_budget[slot] = req.max_new_tokens - 1
            self.slot_last_token[slot] = next_tok

    def _insert_cache(self, slot: int, cache1: Dict[str, torch.Tensor]) -> None:
        # an in-place slice copy of every entry (k/v and the
        # encoder-decoder's cross_k/v; or state, conv and the hybrid's
        # shared_k/v) into the device cache (the reference's
        # dynamic_update_slice builds a new array instead):
        # dst (L, B, ...), src (L, 1, ...)
        with _obs_span("serve.insert"):
            for name, dst in self.cache.items():
                dst[:, slot:slot + 1].copy_(cache1[name])

    def _decode(self) -> None:
        """The batched decode step over every slot, from ``_inputs`` to
        ``_next``; the cache is updated in place."""
        logits, _ = self.api.decode_step(
            self.env, self.params, self.cache,
            {"tokens": self._inputs[0][:, None], "pos": self._inputs[1]})
        self._next.copy_(torch.argmax(logits[:, 0, :], dim=-1))

    def _capture(self) -> "torch.cuda.CUDAGraph":
        """:meth:`_decode` as a CUDA graph, captured while no slot is in
        use: the warm-up steps and the capture write the cache, which is
        then zeroed again."""
        dev = self.env.device
        with torch.cuda.device(dev):    # the capture's stream is on ``dev``
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP):
                    self._decode()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                self._decode()
        for t in self.cache.values():
            t.zero_()
        return graph

    def _decode_tick(self) -> List[Request]:
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return []
        t0 = time.perf_counter()
        with _obs_span("serve.decode", active=len(active)):
            self._inputs.copy_(torch.from_numpy(np.stack(
                [self.slot_last_token, self.slot_pos]).astype(np.int64)))
            if self._graph is not None:
                self._graph.replay()
            else:
                self._decode()
            with _obs_span("serve.sample"):
                next_tokens = self._next.cpu().numpy()
            self.timings["decode"].append(time.perf_counter() - t0)
        finished: List[Request] = []
        for slot in active:
            req = self.slot_req[slot]
            tok = int(next_tokens[slot])
            req.output.append(tok)
            self.slot_pos[slot] += 1
            self.slot_budget[slot] -= 1
            self.slot_last_token[slot] = tok
            done = (self.slot_budget[slot] <= 0 or tok == self.eos
                    or self.slot_pos[slot] >= self.max_len - 1)
            if done:
                req.finished_at = time.perf_counter()
                for hook in self.on_finish:
                    hook(req, slot)
                finished.append(req)
                self.slot_req[slot] = None
        return finished
