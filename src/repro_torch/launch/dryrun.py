"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step program
for one rank of the production mesh, on meta tensors.

For each cell, rank 0's program — the train step, the prefill or the
serve decode step of :func:`build_cell` — runs on tensors of the ``meta``
device (shapes and dtypes, no memory, no kernel) inside a fake process
group of the production mesh's size (``torch.testing``'s ``FakeStore``:
256 ranks, or 512 with the pod axis), whose collectives accept meta
tensors and move nothing.  The flash and SSD wrappers run their plain
versions on meta tensors, as the reference's dry run lowers its plain
attention and scan (``use_pallas`` is off on host devices): the dry run
launches no kernel.  Recorded, per device:

* ``cost``: FLOPs (``torch.utils.flop_counter.FlopCounterMode``) and bytes
  (each aten op's operand and result bytes, summed by a
  ``TorchDispatchMode``: the definition of XLA's HloCostAnalysis "bytes
  accessed", but over the unfused ops of eager PyTorch, so it counts
  every intermediate a fusion would keep on chip; a view, which moves
  nothing, counts none);
* ``collectives``: the port's own record of what it issued
  (``distributed/collectives.py``: counts, result bytes, ring wire bytes);
* ``memory``: ``args`` the rank's state, batch and cache bytes, ``out``
  the bytes of what the step returns, ``alias`` the donated state (the
  train step's, which AdamW writes in place, or the decode cache), and
  ``temp`` the peak of bytes live in tensors the step created, tracked in
  the same dispatch mode (a tensor's storage counted from the op that
  made it until it is freed);
* ``roofline``: the three terms on an NVIDIA H100 SXM
  (``distributed/roofline.py`` ``H100_SXM``; never the TPU's constants),
  and ``model_flops`` against the FLOPs counted.

``calibrated_metrics`` keeps the reference's two-depth extrapolation: the
port's layers are a loop, so its count at full depth is already exact,
and the extrapolation reproduces it (a check that cost is affine in
depth).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun               # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --out experiments/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from ..distributed.collectives import recording
from ..distributed.roofline import (H100_SXM, flops_per_token,
                                    terms_from_compiled)
from ..models import get_model
from ..models.common import Env
from ..train import AdamWConfig, init_train_state, make_train_step
from .mesh import env_for_mesh, make_production_mesh

META = torch.device("meta")


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A fake process group of ``size`` ranks, this process rank 0, for
    the block (the production mesh without its devices)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """The model's global inputs for a run shape, as meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    i64 = torch.long
    if shape.kind == "train":
        specs = {"tokens": torch.empty((B, S), dtype=i64, device=META),
                 "labels": torch.empty((B, S), dtype=i64, device=META)}
    elif shape.kind == "prefill":
        specs = {"tokens": torch.empty((B, S), dtype=i64, device=META)}
    else:  # decode: one new token against a seq_len-long cache
        specs = {"tokens": torch.empty((B, 1), dtype=i64, device=META),
                 "pos": torch.empty((B,), dtype=i64, device=META)}
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["patch_embeds"] = torch.empty(
            (B, cfg.num_patches, cfg.d_model), dtype=dtype, device=META)
    if cfg.family == "audio" and shape.kind != "decode":
        specs["frames"] = torch.empty(
            (B, cfg.encoder_seq, cfg.d_model), dtype=dtype, device=META)
    return specs


def build_cell(cfg: ModelConfig, shape: ShapeConfig, env: Env, *,
               microbatches: int = 1, lean_optimizer: bool = False):
    """Returns (fn, args, donate): rank 0's step program, its meta-tensor
    arguments (this rank's shard of the state, params or cache, and the
    global batch) and which arguments it donates."""
    api = get_model(cfg)
    batch = input_specs(cfg, shape)
    gen = torch.Generator()
    if shape.kind == "train":
        opt_cfg = AdamWConfig(schedule=cfg.lr_schedule,
                              quantize_nu=lean_optimizer,
                              mu_dtype=torch.bfloat16 if lean_optimizer
                              else torch.float32)
        state = init_train_state(api, gen, opt_cfg, device=META, env=env)
        fn = make_train_step(api, env, opt_cfg, microbatches=microbatches)
        return fn, (state, batch), (0,)
    # production serving holds bf16 weights, fully TP-resident
    params = api.init(gen, device=META, dtype=torch.bfloat16, env=env)
    if shape.kind == "prefill":
        return (lambda p, b: api.prefill(env, p, b)), (params, batch), ()
    cache = api.init_cache(shape.global_batch, shape.seq_len, env,
                           torch.bfloat16)
    return ((lambda p, c, b: api.decode_step(env, p, c, b)),
            (params, cache, batch), (1,))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _is_view(func) -> bool:
    """Whether an aten op returns a view of an input (``select``,
    ``slice``, ``view``...): its result aliases the input unwritten."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _ByteCounter(TorchDispatchMode):
    """Sums each aten op's operand and result bytes, and tracks the peak of
    bytes live in storages the ops create (those of ``given`` excluded)."""

    def __init__(self, given):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, Any] = {}
        self._given = {id(t.untyped_storage()) for t in given}

    def _free(self, key: int, n: int) -> None:
        self._refs.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not _is_view(func):        # a view moves no bytes
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._given or key in self._refs:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._refs[key] = weakref.ref(
                st, lambda _, key=key, n=n: self._free(key, n))
        return out


def _run(fn, args) -> Dict[str, Any]:
    """``fn(*args)`` under the counters: FLOPs, bytes, peak temporaries,
    the outputs' bytes and the collectives."""
    given = _tensors(args)
    with recording() as colls, FlopCounterMode(display=False) as flops, \
            _ByteCounter(given) as counter:
        out = fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes), "temp": counter.peak,
            "out": _storage_bytes(_tensors(out)), "colls": colls}


def _lower_metrics(cfg: ModelConfig, shape: ShapeConfig, env: Env,
                   microbatches: int,
                   lean_optimizer: bool = False) -> Dict[str, float]:
    """flops / bytes / collective wire bytes (per device) for one trace."""
    fn, args, _ = build_cell(cfg, shape, env, microbatches=microbatches,
                             lean_optimizer=lean_optimizer)
    m = _run(fn, args)
    return {"flops": m["flops"], "bytes": m["bytes"],
            "coll": float(m["colls"].total_wire_bytes)}


def calibrated_metrics(cfg: ModelConfig, shape: ShapeConfig, env: Env,
                       microbatches: int,
                       lean_optimizer: bool = False) -> Dict[str, float]:
    """Per-device metrics extrapolated from two small depths.

    The reference needs this because XLA's HloCostAnalysis counts a
    while-loop body once; costs are affine in depth — cost(L) = a + b*L —
    so two unrolled depths give a and b.  The port's layers are a Python
    loop, so its direct count is exact and this extrapolation reproduces
    it."""
    if cfg.family == "hybrid":
        l1, l2 = cfg.attn_period, 2 * cfg.attn_period
    else:
        l1, l2 = 1, 2

    def with_depth(l: int) -> ModelConfig:
        kw = {"num_layers": l}
        if cfg.family == "audio":
            kw["encoder_layers"] = l
        return dataclasses.replace(cfg, **kw)

    m1 = _lower_metrics(with_depth(l1), shape, env, microbatches,
                        lean_optimizer)
    m2 = _lower_metrics(with_depth(l2), shape, env, microbatches,
                        lean_optimizer)
    scale = (cfg.num_layers - l1) / (l2 - l1)
    return {k: m1[k] + (m2[k] - m1[k]) * scale for k in m1}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful model FLOPs: 6*N_active*D for train; for inference shapes,
    per-token forward FLOPs including the attention-over-context term."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        # mean live context is seq/2 for causal prefill
        return flops_per_token(cfg, shape.seq_len // 2) \
            * shape.global_batch * shape.seq_len
    return flops_per_token(cfg, shape.seq_len) * shape.global_batch


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             microbatches: int = 1, env_overrides: Optional[Dict] = None,
             calibrate: bool = True,
             cfg_overrides: Optional[Dict] = None,
             lean_optimizer: bool = False) -> Dict[str, Any]:
    """One cell: rank 0's step on meta tensors under a fake process group
    of the production mesh's size (initialised here, destroyed after)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                            "mesh": mesh_name}

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        cell.update(status="skipped", reason=reason)
        return cell

    t0 = time.time()
    try:
        chips = 512 if multi_pod else 256
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            env = env_for_mesh(mesh, META, **(env_overrides or {}))
            fn, args, donate = build_cell(cfg, shape, env,
                                          microbatches=microbatches,
                                          lean_optimizer=lean_optimizer)
            t_build = time.time() - t0
            m = _run(fn, args)
            t_trace = time.time() - t0 - t_build
            if calibrate:
                cal = calibrated_metrics(cfg, shape, env, microbatches,
                                         lean_optimizer)
            else:
                cal = {"flops": m["flops"], "bytes": m["bytes"],
                       "coll": float(m["colls"].total_wire_bytes)}
        colls = m["colls"]
        args_bytes = _storage_bytes(_tensors(args))
        alias_bytes = _storage_bytes(
            [t for i in donate for t in _tensors(args[i])])
        coll_dev = float(colls.total_wire_bytes)
        terms = terms_from_compiled(cal["flops"], cal["bytes"], cal["coll"],
                                    hardware=H100_SXM)
        mf = model_flops(cfg, shape)
        flops_global = cal["flops"] * chips
        cell.update(
            status="ok",
            chips=chips,
            hardware=H100_SXM.name,
            lower_s=round(t_build, 1),
            compile_s=round(t_trace, 1),
            memory=dict(
                args_bytes=args_bytes,
                out_bytes=m["out"],
                temp_bytes=m["temp"],
                alias_bytes=alias_bytes,
                total_per_device=(args_bytes + m["out"] + m["temp"]
                                  - alias_bytes),
            ),
            cost=dict(flops_per_device=m["flops"],
                      bytes_per_device=m["bytes"],
                      flops_per_device_corrected=cal["flops"],
                      bytes_per_device_corrected=cal["bytes"],
                      coll_per_device_corrected=cal["coll"]),
            collectives=dict(counts=colls.counts,
                             wire_bytes=colls.wire_bytes,
                             raw_bytes=colls.raw_bytes,
                             per_device_wire_bytes=coll_dev),
            roofline=dict(compute_s=terms.compute_s,
                          memory_s=terms.memory_s,
                          collective_s=terms.collective_s,
                          dominant=terms.dominant,
                          step_s_bound=terms.step_s),
            model_flops=mf,
            hlo_flops_global=flops_global,
            useful_flops_ratio=(mf / flops_global if flops_global
                                else None),
        )
    except Exception as err:  # noqa: BLE001 - report, don't crash the matrix
        cell.update(status="error", error=f"{type(err).__name__}: {err}",
                    traceback=traceback.format_exc()[-2000:])
    return cell


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-calibrate", action="store_true",
                    help="skip the L=1/L=2 cost extrapolation")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-shard residual activations over tp")
    ap.add_argument("--attn-chunk", type=int, default=0,
                    help="query-chunked attention block size")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "dots"])
    ap.add_argument("--lean-optimizer", action="store_true",
                    help="int8 nu + bf16 mu optimizer state")
    ap.add_argument("--ssm-chunk", type=int, default=0,
                    help="override the SSD chunk length (ssm/hybrid archs)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.list:
        for a in archs:
            for s in shapes:
                ok, why = shape_applicable(get_config(a), SHAPES[s])
                print(f"{a:24s} {s:12s} {'ok' if ok else 'SKIP: ' + why}")
        return []

    os.makedirs(args.out, exist_ok=True)
    overrides: Dict[str, Any] = {}
    if args.seq_shard:
        overrides["seq_shard_activations"] = True
    if args.attn_chunk:
        overrides["attn_q_chunk"] = args.attn_chunk
    if args.remat_policy != "nothing":
        overrides["remat_policy"] = args.remat_policy
    cfg_over = {"ssm_chunk": args.ssm_chunk} if args.ssm_chunk else None
    results = []
    for multi in meshes:
        for a in archs:
            for s in shapes:
                cell = run_cell(a, s, multi_pod=multi,
                                microbatches=args.microbatches,
                                calibrate=not args.no_calibrate,
                                env_overrides=overrides or None,
                                cfg_overrides=cfg_over,
                                lean_optimizer=args.lean_optimizer)
                results.append(cell)
                name = f"{cell['mesh']}-{a}-{s}.json"
                with open(os.path.join(args.out, name), "w") as f:
                    json.dump(cell, f, indent=2)
                _print_cell(cell)
    n_ok = sum(1 for c in results if c["status"] == "ok")
    n_skip = sum(1 for c in results if c["status"] == "skipped")
    n_err = sum(1 for c in results if c["status"] == "error")
    print(f"\n== dry-run done: {n_ok} ok, {n_skip} skipped, {n_err} errors ==")
    if n_err:
        raise SystemExit(1)
    return results


def _print_cell(c: Dict[str, Any]) -> None:
    tag = f"{c['mesh']} {c['arch']} {c['shape']}"
    if c["status"] == "skipped":
        print(f"[SKIP] {tag}: {c['reason'][:80]}")
        return
    if c["status"] == "error":
        print(f"[ERR ] {tag}: {c['error'][:160]}")
        return
    m = c["memory"]["total_per_device"] / 2**30
    r = c["roofline"]
    print(f"[ OK ] {tag}: mem/dev={m:.2f}GiB "
          f"compute={r['compute_s']*1e3:.2f}ms memory={r['memory_s']*1e3:.2f}ms "
          f"coll={r['collective_s']*1e3:.2f}ms dom={r['dominant']} "
          f"useful={c['useful_flops_ratio'] and round(c['useful_flops_ratio'], 3)} "
          f"(build {c['lower_s']}s trace {c['compile_s']}s, "
          f"{c['hardware']})")


if __name__ == "__main__":
    main()
