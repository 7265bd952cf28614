"""Sharding rules: parameter / batch / cache partition specs, and the
port's layout of each rank's shard.

2-D sharding scheme (the reference's ``distributed/sharding.py``):

* ``tp``   ("model" axis): attention heads, FFN hidden, vocab, experts
* ``fsdp`` (the batch axes, e.g. ("pod","data")): the d_model-ish dimension
  of every large matrix, ZeRO-3-style; serving (``serving=True``) drops it
* batch:   global-batch dimension of activations over the batch axes

``_PARAM_RULES``, ``_fit``, ``param_spec``, ``batch_spec`` and
``cache_spec`` are the reference's, unchanged, over the reference's paths
and (in, out) shapes; a spec is a :class:`PartitionSpec`, a tuple with one
entry per dimension (None, an axis name, or a tuple of names).
:func:`port_param_spec` carries a rule to the port's layout: one dict per
layer instead of stacked ``blocks/`` (no leading layer entry), and
projections stored (out, in), so the trailing two entries swap where
``models/convert.py``'s ``reference_last_axis`` says the axis moved.

Each rank of a run holds only its shard.  :func:`local_index` gives the
port's shard of every leaf, which is the rule's (:func:`local_shard` of the
port spec) wherever the rule splits whole heads, hidden units, vocab rows
or experts.  Where a rule's even split would cut through a structure the
port's explicit collectives cannot repair (GSPMD repairs it silently), the
port splits by structure instead and the outputs stay the same:

* ``ssm/in_proj`` (the rule: rows over tp) projects to the concatenation
  ``z | x | B | C | dt``.  A rank keeps the rows of its heads' ``z``, ``x``
  and ``dt`` and all ``N`` rows of ``B`` and of ``C`` (one SSM group,
  shared by every head).  ``conv_w``/``conv_b`` and the conv cache keep
  the channels of its heads' ``x`` and all of ``B`` and ``C``; ``norm`` its
  heads' channels (the gated RMS norm sums its squares over tp);
  ``out_proj`` its heads' columns (row-parallel).
* Attention heads that do not divide the tp width replicate (the rule may
  split the columns of ``wq`` mid-head).
* KV heads that do not divide the tp width: the reference's cache shards
  the KV *sequence* over tp (``cache_spec``'s GQA fallback); each rank of
  the port keeps the KV heads its query heads read, replicated where ranks
  share one (ROADMAP, Queue 1).
* whisper's ``pos_embed``: the rule ``embed$`` matches it too and splits
  its 4096 rows over tp; the port keeps the table whole on every rank and
  looks positions up directly.
* The batch axes: a batch that they do not divide replicates; the
  reference's long-context cache spreads the KV sequence over them
  instead.

Training (``local_index(..., batch_axes=...)``, the rule with
``serving=False``) also keeps the rank's block of every dimension the rule
gives "F" (the batch axes), ZeRO-3 style: the fp32 master and AdamW's
moments are that shard, and each layer all-gathers its working weights
over the batch axes just before use (``models/common.py``
``fsdp_gather``), whose backward reduce-scatters their gradients.  A leaf
replicated over some ranks has its gradient summed over exactly the ranks
that computed different parts of it (:func:`grad_rule`,
:func:`reduce_grads`):

* a leaf that ``_fit`` leaves whole over the batch axes (norm gains,
  biases, anything whose "F" dimension does not divide): the batch axes'
  sum (an all-reduce), as every batch rank saw other tokens;
* a KV head shared by tp ranks (GQA below the width): the ``wk``/``wv``
  (and ``bk``/``bv``) rows of the ranks that hold it, summed through a
  buffer of all ``K * hd`` rows over tp (each rank adds only the heads its
  query heads read);
* the SSM's ``B``/``C`` rows of ``in_proj`` and their conv channels
  (``conv_w``, ``conv_b``), kept by every tp rank: the tp sum, as each
  rank's heads read them;
* everything else replicated over tp (norms, a replicated vocabulary, the
  attention where heads do not divide, whisper's ``pos_embed``) is computed
  whole on every tp rank, so its gradient is already the same there;
  where the model code makes ranks compute different parts of such a leaf
  it sums them itself, in the graph: the MoE router under token
  parallelism and the norm gains under sequence parallelism
  (``collectives.copy_to`` on the weight).

The same rules say which rank *owns* a replicated element (the first of
those holding it), so a global norm counts every element once
(:func:`owned_mask`).

The rules need only the mesh's axis names and sizes, so they run on
meshes of names and sizes alone, with no process group.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh

#: per dimension, the indices a rank keeps (None: all of them)
Index = Tuple[Optional[torch.Tensor], ...]


class PartitionSpec(tuple):
    """One entry per dimension: None, an axis name or a tuple of names.
    A one-name tuple is kept as the reference's ``P`` normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


def _axis_size(mesh: Mesh, entry) -> int:
    return mesh.axis_size(entry)


def _fit(mesh: Mesh, spec_entries: Sequence, shape: Sequence[int]) -> P:
    """Drop spec entries that don't divide the dimension."""
    fixed = []
    for entry, dim in zip(spec_entries, shape):
        if entry is not None and dim % _axis_size(mesh, entry) == 0:
            fixed.append(entry)
        else:
            fixed.append(None)
    return P(*fixed)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

#: (path regex, spec entries *for the trailing dims*).  Stacked layer params
#: get a leading None automatically (their first dim is the layer axis).
#: FSDP is spelled "F", tensor-parallel "T" — resolved against the env.
_PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # embeddings / head
    (r"embed$",               ("T", "F")),
    (r"pos_embed$",           (None, "F")),
    (r"head$",                ("F", "T")),
    # attention
    (r"attn/wq$",             ("F", "T")),
    (r"attn/wk$",             ("F", "T")),
    (r"attn/wv$",             ("F", "T")),
    (r"attn/wo$",             ("T", "F")),
    (r"attn/b[qkv]$",         ("T",)),
    # dense mlp
    (r"mlp/w[gu]$",           ("F", "T")),
    (r"mlp/wd$",              ("T", "F")),
    (r"mlp/w1$",              ("F", "T")),
    (r"mlp/w2$",              ("T", "F")),
    (r"mlp/b1$",              ("T",)),
    (r"mlp/b2$",              (None,)),
    # moe (expert axis on T; D on F gives ZeRO gathering inside shard_map)
    (r"moe/router$",          ("F", None)),
    (r"moe/w[gu]$",           ("T", "F", None)),
    (r"moe/wd$",              ("T", None, "F")),
    (r"moe/shared/w[gu]$",    ("F", "T")),
    (r"moe/shared/wd$",       ("T", "F")),
    # ssm
    (r"ssm/in_proj$",         ("F", "T")),
    (r"ssm/out_proj$",        ("T", "F")),
    (r"ssm/conv_w$",          (None, "T")),
    (r"ssm/conv_b$",          ("T",)),
    (r"ssm/(A_log|D|dt_bias)$", ("T",)),
    (r"ssm/norm$",            ("T",)),
)


def param_spec(env, path_str: str, shape: Sequence[int],
               *, serving: bool = False) -> P:
    """PartitionSpec for one parameter leaf of the reference's tree.

    ``serving=True`` drops the FSDP axis (params replicate across the batch
    axes, staying fully TP-resident): decode re-reads every weight each
    step, so FSDP sharding would re-all-gather the whole model per token.
    """
    mesh = env.mesh
    if mesh is None:
        return P()
    fsdp = (None if serving else
            (tuple(env.batch_axes) if env.batch_axes else None))
    tp = env.tp_axis
    resolve = {"F": fsdp, "T": tp, None: None}
    stacked = bool(re.search(r"(blocks|enc_blocks|dec_blocks)/", path_str))
    for pattern, entries in _PARAM_RULES:
        if re.search(pattern, path_str):
            resolved = tuple(resolve[e] for e in entries)
            if stacked:
                resolved = (None,) + resolved
            if len(resolved) < len(shape):   # e.g. ln dicts etc.
                resolved = resolved + (None,) * (len(shape) - len(resolved))
            resolved = resolved[: len(shape)]
            return _fit(mesh, resolved, shape)
    # default: replicate small leaves; shard big 1-D leaves over fsdp
    if len(shape) == 1 and fsdp and shape[0] % _axis_size(mesh, fsdp) == 0 \
            and shape[0] >= 1 << 16:
        return P(fsdp)
    return P(*([None] * len(shape)))


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------

def batch_spec(env, name: str, shape: Sequence[int]) -> P:
    mesh = env.mesh
    if mesh is None:
        return P()
    b = tuple(env.batch_axes) if env.batch_axes else None
    entries = [b] + [None] * (len(shape) - 1)
    return _fit(mesh, entries, shape)


def cache_spec(env, name: str, shape: Sequence[int]) -> P:
    """KV/state caches: (L, B, ...) — batch over batch axes, heads over tp."""
    mesh = env.mesh
    if mesh is None:
        return P()
    b = tuple(env.batch_axes) if env.batch_axes else None
    tp = env.tp_axis
    batch_fits = b is not None and shape[1] % _axis_size(mesh, b) == 0
    if name.endswith(("k", "v")):            # (L, B, S, K, hd)
        kv_heads_fit = tp is not None and shape[3] % _axis_size(mesh, tp) == 0
        if batch_fits and kv_heads_fit:
            entries = [None, b, None, tp, None]
        elif batch_fits:
            # GQA kv heads below the tp width: shard the KV *sequence* over
            # tp instead (flash-decode partial softmax) so the model axis
            # isn't idle during decode
            entries = [None, b, tp, None, None]
        else:
            # long-context decode at tiny batch: KV sequence over the batch
            # axes, kv heads over tp when they fit
            entries = [None, None, b, tp if kv_heads_fit else None, None]
    elif name.endswith("state"):             # (L, B, H, hd, N)
        entries = [None, b, tp, None, None]
    elif name.endswith("conv"):              # (L, B, W-1, C)
        entries = [None, b, None, tp]
    else:
        entries = [None, b] + [None] * (len(shape) - 2)
    return _fit(mesh, entries[: len(shape)], shape)


# ---------------------------------------------------------------------------
# The port's layout
# ---------------------------------------------------------------------------

_STACKS = ("blocks", "enc_blocks", "dec_blocks")
#: the 2-D leaves the port keeps in the reference's layout
#: (``models/convert.py``)
_MATRICES_AS_IS = ("embed", "pos_embed", "conv_w")


def reference_path(port_path: str) -> Tuple[str, bool]:
    """The reference's path of a port leaf, and whether it is stacked:
    ``blocks/3/attn/wq`` -> (``blocks/attn/wq``, True)."""
    parts = port_path.split("/")
    if parts[0] in _STACKS and len(parts) > 1 and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), True
    return port_path, False


def transposed(port_path: str, ndim: int) -> bool:
    """Whether the port stores the leaf (out, in) against the reference's
    (in, out): every matrix but the embedding, the position table and the
    conv weights (``models/convert.py``)."""
    name = port_path.rsplit("/", 1)[-1]
    return ndim == 2 and name not in _MATRICES_AS_IS


def port_param_spec(env, port_path: str, shape: Sequence[int], *,
                    num_layers: int = 1, serving: bool = False) -> P:
    """The rule for a port leaf, in the port's layout: the reference's
    spec at its path and (in, out) shape, its layer entry dropped and its
    trailing entries swapped where the port transposed the leaf."""
    ref_path, stacked = reference_path(port_path)
    swap = transposed(port_path, len(shape))
    ref_shape = tuple(shape[::-1]) if swap else tuple(shape)
    if stacked:
        ref_shape = (num_layers,) + ref_shape
    spec = tuple(param_spec(env, ref_path, ref_shape, serving=serving))
    if env.mesh is None:
        return P()
    if stacked:
        spec = spec[1:]
    return P(*(spec[::-1] if swap else spec))


def local_shard(full, spec: Sequence, mesh: Mesh,
                coords: Optional[Dict[str, int]] = None):
    """This rank's block of ``full`` (a tensor or numpy array) under
    ``spec``: each sharded dimension is cut into the axis group's size in
    equal blocks, the block at the rank's position (the first axis of a
    tuple the slowest)."""
    idx = []
    for dim, entry in zip(full.shape, tuple(spec) + (None,) * full.ndim):
        if entry is None:
            idx.append(slice(None))
            continue
        n = mesh.axis_size(entry)
        if dim % n:
            raise ValueError(f"dimension {dim} does not divide over {entry}")
        step = dim // n
        at = mesh.index(entry, coords)
        idx.append(slice(at * step, (at + 1) * step))
    return full[tuple(idx)]


def _block(n: int, parts: int, at: int) -> torch.Tensor:
    step = n // parts
    return torch.arange(at * step, (at + 1) * step)


def kv_heads(num_heads: int, num_kv_heads: int, tp: int, rank: int,
             shard_heads: bool) -> Tuple[int, int]:
    """(first, count) of the KV heads a tp rank keeps: its block where the
    KV heads divide the width; else the heads its query block reads (query
    head h reads KV head h // (H / K)); all of them where the query heads
    replicate."""
    H, K = num_heads, num_kv_heads
    if not shard_heads:
        return 0, K
    if K % tp == 0:
        return rank * (K // tp), K // tp
    h_l, G = H // tp, H // K
    first = (rank * h_l) // G
    last = ((rank + 1) * h_l - 1) // G
    return first, last - first + 1


def kv_map(num_heads: int, num_kv_heads: int, tp: int, rank: int,
           shard_heads: bool) -> Optional[torch.Tensor]:
    """For each local query head, its local KV head, where that is not
    the uniform grouping ``j // (H_l / K_l)`` the attention assumes; None
    where it is."""
    first, k_l = kv_heads(num_heads, num_kv_heads, tp, rank, shard_heads)
    h_l = num_heads // tp if shard_heads else num_heads
    G = num_heads // num_kv_heads
    glob = torch.arange(h_l) + (rank * h_l if shard_heads else 0)
    local = glob // G - first
    if h_l % k_l == 0 and torch.equal(local, torch.arange(h_l)
                                      // (h_l // k_l)):
        return None
    return local


def _ssm_rows(cfg, tp: int, r: int) -> Dict[str, torch.Tensor]:
    """The head-aligned split of a Mamba2 block: the channel indices of
    this rank's heads within ``d_inner``, and its rows of ``in_proj``
    (``z | x | B | C | dt``) and channels of the conv (``x | B | C``)."""
    d_in = cfg.ssm_expand * cfg.d_model
    hd, N = cfg.ssm_head_dim, cfg.ssm_state
    H = d_in // hd
    h_l = H // tp
    heads = torch.arange(r * h_l, (r + 1) * h_l)
    chans = (heads[:, None] * hd + torch.arange(hd)).reshape(-1)
    bc = torch.arange(2 * N)
    return {"heads": heads, "chans": chans,
            "in_proj": torch.cat([chans, d_in + chans, 2 * d_in + bc,
                                  2 * d_in + 2 * N + heads]),
            "conv": torch.cat([chans, d_in + bc])}


class _RuleEnv(NamedTuple):
    """What the rules read of an ``Env``."""
    mesh: Mesh
    batch_axes: Tuple[str, ...]
    tp_axis: Optional[str]


def fsdp_dim(mesh: Optional[Mesh], batch_axes: Sequence[str], path: str,
             shape: Sequence[int]) -> Optional[int]:
    """The dimension of the port leaf at ``path`` (full ``shape``) that
    training splits over ``batch_axes`` (the rule's "F", where it
    divides), or None."""
    if mesh is None or not batch_axes:
        return None
    env = _RuleEnv(mesh, tuple(batch_axes),
                   "model" if "model" in mesh.shape else None)
    spec = port_param_spec(env, path, shape, serving=False)
    for dim, entry in enumerate(spec):
        if entry == tuple(batch_axes):
            return dim
    return None


def local_index(cfg, mesh: Optional[Mesh], path: str,
                shape: Sequence[int],
                coords: Optional[Dict[str, int]] = None, *,
                batch_axes: Sequence[str] = ()) -> Index:
    """Per dimension of the port leaf at ``path`` (full ``shape``), the
    indices this rank keeps, or None for all of them.  Only the tp axis
    ("model") splits a weight in serving; see the module's notes for where
    the split follows the structure rather than the rule.  With
    ``batch_axes`` (training), the rank also keeps its block of the
    dimension :func:`fsdp_dim` names."""
    index = list(_tp_index(cfg, mesh, path, shape, coords))
    dim = fsdp_dim(mesh, batch_axes, path, shape)
    if dim is not None:
        coords = mesh.coords if coords is None else coords
        index[dim] = _block(shape[dim], mesh.axis_size(tuple(batch_axes)),
                            mesh.index(tuple(batch_axes), coords))
    # a block of one part is the whole dimension
    return tuple(None if ix is not None and len(ix) == n and
                 bool((ix == torch.arange(n)).all()) else ix
                 for ix, n in zip(index, shape))


def _tp_index(cfg, mesh: Optional[Mesh], path: str, shape: Sequence[int],
              coords: Optional[Dict[str, int]] = None) -> Index:
    """The tp part of :func:`local_index`."""
    none: Index = (None,) * len(shape)
    if mesh is None or "model" not in mesh.shape:
        return none
    tp = mesh.shape["model"]
    r = (mesh.coords if coords is None else coords)["model"]
    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    grand = parts[-3] if len(parts) > 2 else ""

    def on(dim: int, ix: Optional[torch.Tensor]) -> Index:
        out = list(none)
        out[dim] = ix
        return tuple(out)

    def block(dim: int, n: int) -> Index:
        return on(dim, _block(shape[dim], tp, r) if n % tp == 0 else None)

    if name in ("embed", "head"):
        return block(0, cfg.vocab_size)
    if parent in ("attn", "self_attn", "cross_attn"):
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        shard = H % tp == 0
        if not shard:
            return none
        if name in ("wq", "bq"):
            return block(0, H)
        if name == "wo":
            return block(1, H)
        first, k_l = kv_heads(H, K, tp, r, shard)
        return on(0, torch.arange(first * hd, (first + k_l) * hd))
    if parent == "moe":
        if name == "router":
            return none
        if cfg.num_experts % tp:
            raise ValueError(f"{cfg.num_experts} experts do not divide over "
                             f"tp {tp}")
        return block(0, cfg.num_experts)
    if parent in ("mlp", "shared") and name in ("wg", "wu", "wd", "w1", "b1",
                                                 "w2", "b2"):
        ff = cfg.d_ff * (cfg.shared_experts if grand == "moe" else 1)
        if name in ("wg", "wu", "w1", "b1"):
            return block(0, ff)
        if name in ("wd", "w2"):
            return block(1, ff)
        return none
    if parent == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        if (d_in // cfg.ssm_head_dim) % tp:
            return none
        dim, part = {"in_proj": (0, "in_proj"), "conv_w": (1, "conv"),
                     "conv_b": (0, "conv"), "A_log": (0, "heads"),
                     "D": (0, "heads"), "dt_bias": (0, "heads"),
                     "norm": (0, "chans"), "out_proj": (1, "chans")}[name]
        return on(dim, _ssm_rows(cfg, tp, r)[part])
    return none


@dataclasses.dataclass(frozen=True)
class GradRule:
    """How one leaf's gradient is completed and its elements counted,
    on one rank (see the module's notes)."""

    #: the rank's training-layout index of the leaf
    index: Index
    #: the dimension split over the batch axes, or None
    fsdp_dim: Optional[int]
    #: replicated over the batch axes: its gradient is summed over them
    dp_sum: bool
    #: rows (``dim``) kept by several tp ranks: the local positions, their
    #: slots in a buffer of ``slots`` rows summed over tp
    tp_shared: Optional[Tuple[int, torch.Tensor, torch.Tensor, int]]
    #: which local elements this rank owns: True (all), False (none) or
    #: ``(dim, bool mask)``
    owned: object


def _kv_first_holders(cfg, tp: int) -> Dict[int, int]:
    """For each KV head, the lowest tp rank holding it."""
    first: Dict[int, int] = {}
    for r in range(tp):
        f, n = kv_heads(cfg.num_heads, cfg.num_kv_heads, tp, r, True)
        for j in range(f, f + n):
            first.setdefault(j, r)
    return first


def grad_rule(cfg, env, path: str, shape: Sequence[int]) -> GradRule:
    """The gradient rule of the port leaf at ``path`` (full ``shape``) on
    this rank of ``env``'s mesh (the training layout)."""
    mesh = env.mesh
    batch = tuple(env.batch_axes)
    index = local_index(cfg, mesh, path, shape, batch_axes=batch)
    tp_index = _tp_index(cfg, mesh, path, shape)
    dp = env.dp
    f_dim = fsdp_dim(mesh, batch, path, shape)
    dp_owner = f_dim is not None or not batch or mesh.index(batch) == 0
    tp = env.tp
    r = env.tp_rank
    parts = path.split("/")
    name, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    shared = None
    owned: object = True
    if all(ix is None for ix in tp_index):
        owned = r == 0                    # whole on every tp rank
    elif parent in ("attn", "self_attn", "cross_attn") and \
            name in ("wk", "wv", "bk", "bv") and cfg.num_kv_heads % tp:
        hd = cfg.head_dim
        rows = tp_index[0]
        first = _kv_first_holders(cfg, tp)
        shared = (0, torch.arange(len(rows)), rows, cfg.num_kv_heads * hd)
        owned = (0, torch.tensor([first[int(g) // hd] == r for g in rows]))
    elif parent == "ssm" and name in ("in_proj", "conv_w", "conv_b"):
        N = cfg.ssm_state
        d_l = (cfg.ssm_expand * cfg.d_model) // tp
        start = 2 * d_l if name == "in_proj" else d_l
        dim = 1 if name == "conv_w" else 0
        local = torch.arange(start, start + 2 * N)
        shared = (dim, local, torch.arange(2 * N), 2 * N)
        n = len(tp_index[dim])
        mask = torch.ones(n, dtype=torch.bool)
        mask[local] = r == 0
        owned = (dim, mask)
    if not dp_owner:
        owned = False
    return GradRule(index, f_dim, dp > 1 and f_dim is None, shared, owned)


def owned_mask(rule: GradRule, g: torch.Tensor) -> Optional[torch.Tensor]:
    """A 0/1 float mask broadcastable to the local ``g`` that counts each
    replicated element on one rank only; None where the rank owns all."""
    if rule.owned is True:
        return None
    if rule.owned is False:
        return torch.zeros((), dtype=torch.float32, device=g.device)
    dim, mask = rule.owned
    shape = [1] * g.ndim
    shape[dim] = g.shape[dim]
    return mask.to(device=g.device, dtype=torch.float32).reshape(shape)


def reduce_grads(env, rules: Dict[str, GradRule],
                 grads: Dict[str, torch.Tensor]) -> None:
    """Complete each gradient (path -> local tensor, in place) by its rule:
    the batch axes' sum of a leaf replicated over them, the tp sum of the
    rows kept by several tp ranks.  The FSDP leaves' batch sum happened in
    the backward of their gather."""
    from . import collectives
    for path, g in grads.items():
        rule = rules[path]
        if rule.dp_sum:
            collectives.all_reduce(g, env.mesh.group(tuple(env.batch_axes)))
        if rule.tp_shared is not None and env.tp > 1:
            dim, local, slots, n = rule.tp_shared
            part = g.index_select(dim, local.to(g.device))
            shape = list(part.shape)
            shape[dim] = n
            buf = part.new_zeros(shape)
            buf.index_copy_(dim, slots.to(g.device), part)
            collectives.all_reduce(buf, env.tp_group)
            g.index_copy_(dim, local.to(g.device),
                          buf.index_select(dim, slots.to(g.device)))


def take(full, index: Index):
    """``full`` (tensor or numpy array) at ``index`` (one per dimension)."""
    out = full
    for dim, ix in enumerate(index):
        if ix is None:
            continue
        if isinstance(out, np.ndarray):
            out = np.take(out, ix.numpy(), axis=dim)
        else:
            out = out.index_select(dim, ix.to(out.device))
    return out


def local_cache_index(cfg, env, name: str, shape: Sequence[int]) -> Index:
    """Per dimension of a cache entry (L, B, ...) of full ``shape``, the
    indices this rank keeps: the batch over the batch axes where they
    divide it; the KV heads of :func:`kv_heads`; an SSM's heads and its conv
    channels as ``local_index`` splits ``in_proj``."""
    idx = [None] * len(shape)
    mesh = env.mesh
    if mesh is None:
        return tuple(idx)
    b = tuple(env.batch_axes) if env.batch_axes else None
    if b is not None and shape[1] % mesh.axis_size(b) == 0:
        idx[1] = _block(shape[1], mesh.axis_size(b), mesh.index(b))
    if env.tp_axis is None:
        return tuple(idx)
    tp, r = env.tp, env.tp_rank
    if name in ("k", "v", "shared_k", "shared_v", "cross_k", "cross_v"):
        shard = cfg.num_heads % tp == 0
        first, k_l = kv_heads(cfg.num_heads, cfg.num_kv_heads, tp, r, shard)
        idx[3] = torch.arange(first, first + k_l)
    elif name in ("state", "conv"):
        d_in = cfg.ssm_expand * cfg.d_model
        if (d_in // cfg.ssm_head_dim) % tp == 0:
            rows = _ssm_rows(cfg, tp, r)
            if name == "state":
                idx[2] = rows["heads"]
            else:
                idx[3] = rows["conv"]
    return tuple(idx)


def local_batch(env, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch (every entry's leading axis over
    the batch axes, by :func:`batch_spec`)."""
    if env.mesh is None:
        return batch
    return {k: local_shard(v, batch_spec(env, k, v.shape), env.mesh)
            for k, v in batch.items()}
