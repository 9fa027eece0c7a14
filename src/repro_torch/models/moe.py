"""Mixture-of-Experts block of the moe family (arctic-480b, kimi-k2-1t-a32b).

The JAX package's function (``src/repro/models/moe.py``), kept choice for
choice: top-k routing, then the capacity-bounded dispatch of Switch/GShard
-- each expert takes its first C assignments in flat (t·K + k) order, C
set by the call's token count (:func:`capacity`), the rest dropped -- the
experts' SwiGLU over the (E, C, d) capacity buffer, and the combine of each
token's K rows by their routing weights.  Arctic adds a dense residual MLP
in parallel (``cfg.dense_residual``).

Routing and the combine stay PyTorch ops, with no host sync (a CUDA graph
captures them):
- ties in top-k keep the lower expert index, as ``lax.top_k`` does: a
  stable descending sort, not ``torch.topk``;
- an assignment's place in its expert is a stable sort's rank, with the
  expert's start found by ``searchsorted`` (no ``bincount``);
- the row map is written once per kept slot; dropped assignments write to
  a sentinel entry, never onto a slot another token fills;
- each token's K rows are summed in k order in x's dtype, as the
  reference's scatter-add from zeros, not by ``index_add_``'s atomics.

Under ``kernel_impl="cuda"`` the router and the dense residual go through
``gemm_rowinv`` and the expert products through ``moe_gemm`` (two launches
a layer: gate and up fused, then down), which reads the row map and the
per-expert counts on the device and skips the experts and rows the call
does not fill; ``"reference"`` runs the kernels' plain versions, the
reference's dense einsums.  In training (``mode="train"``) the products
are the reference's and the block returns the router's
:func:`aux_load_balance_loss` in its cache's place.

Under a mesh with a "model" axis and ``cfg.ep_shard_map``, the block runs
:func:`moe_ffn_ep`, the reference's expert-parallel dispatch: each model
rank holds E/par experts and routes all of its tokens; it keeps its own
assignments and sends every other one to its local expert 0 with weight
0, where it takes a capacity slot and computes a zero row, as the
reference does; its experts run on ``moe_gemm`` through the same row map,
and one ``all_reduce`` over "model" sums the ranks' partial outputs.

Under a "model" axis without ``cfg.ep_shard_map`` (the reference's
tensor parallelism, :func:`moe_ffn_tp`), the router is column-sliced and
its logits are gathered before top-k; the experts are sliced by expert.
Every rank routes and dispatches the whole capacity buffer as one rank
does (the reference's capacity and drops), computes its experts' rows of
that buffer and combines the assignments they hold, and the partial
outputs are summed over "model".  Attention and arctic's dense residual
MLP are tensor-parallel as in the dense block.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.distributed.sharding import (MODEL, batch_axes, copy_to, current_mesh,
                                               gather_from, model_offset, reduce_from)
from repro_torch.kernels.moe_gemm import moe_gemm_plain
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.params import Spec

CAPACITY_FACTOR = 1.25

_drops = threading.local()


def moe_block_spec(cfg, par: int = 1) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    # Expert parallelism routes on every rank: the router is replicated.
    router_pspec = (None, None) if cfg.ep_shard_map else (None, "model")
    spec = {
        "attn": A.attn_spec(cfg, par),
        "router": Spec((d, E), "small_normal", 0.02, pspec=router_pspec),
        "experts": {
            "w_gate": Spec((E, d, f), pspec=("model", None, None)),
            "w_up": Spec((E, d, f), pspec=("model", None, None)),
            "w_down": Spec((E, f, d), pspec=("model", None, None)),
        },
        "norm1": Spec((d,), "ones", pspec=(None,)),
        "norm2": Spec((d,), "ones", pspec=(None,)),
    }
    if cfg.dense_residual:
        spec["dense_mlp"] = {
            "w_gate": Spec((d, f), pspec=(None, "model")),
            "w_up": Spec((d, f), pspec=(None, "model")),
            "w_down": Spec((f, d), pspec=("model", None)),
        }
    return spec


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens, as the
    reference: ``int(T K 1.25 / E) + 1`` rounded up to 8, at least 8."""
    c = int(n_tokens * cfg.top_k * CAPACITY_FACTOR / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def top_k(probs, k: int):
    """``lax.top_k`` over the last dim: the k largest in descending order,
    the lower index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_gates(x, router, E: int, impl: str = "reference"):
    """The router's float32 logits (T, E) of tokens x (T, d); a router
    column-sliced over "model" gives its columns, gathered whole."""
    mesh = L.sliced(router.shape[1], E)
    gates = L.linear(copy_to(x, mesh, MODEL), router.to(x.dtype), impl).float()
    return gather_from(gates, mesh, MODEL, -1)


def route(x, router, E: int, K: int, impl: str = "reference", gates=None):
    """Top-k routing of tokens x (T, d) (``gates``: the router's logits,
    already computed).  Returns the flat expert ids (T K,), their weights
    in x's dtype (renormalised over each token's K) and each assignment's
    token."""
    if gates is None:
        gates = router_gates(x, router, E, impl)
    w, ids = top_k(torch.softmax(gates, dim=-1), K)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    tok = torch.arange(ids.numel(), device=x.device) // K
    return ids.reshape(-1), w.reshape(-1).to(x.dtype), tok


def dispatch(fids, fw, tok, E: int, C: int):
    """The reference's placement: each assignment's position in its expert
    in flat order; ``keep`` where it is below C and its weight nonzero;
    dropped assignments clamp to slot C - 1.  Returns (slot, keep, rows,
    count): ``rows`` (E, C) int32 the token of each slot (-1: a zero row,
    as the reference's buffer holds there), ``count`` (E,) int32 the
    filled slots of each expert."""
    n = fids.shape[0]
    order = torch.sort(fids, stable=True).indices
    sids = fids[order]
    experts = torch.arange(E, device=fids.device, dtype=fids.dtype)
    starts = torch.searchsorted(sids, experts)
    ends = torch.searchsorted(sids, experts, right=True)
    pos_sorted = torch.arange(n, device=fids.device) - starts[sids]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    placed = pos < C
    keep = placed & (fw != 0)
    # One write per placed assignment (unique (expert, slot)); the dropped
    # ones all go to the sentinel entry E C, cut off below.
    flat = torch.full((E * C + 1,), -1, dtype=torch.int32, device=fids.device)
    flat.scatter_(0, torch.where(placed, fids * C + pos, E * C),
                  torch.where(keep, tok, -1).to(torch.int32))
    count = torch.clamp(ends - starts, max=C).to(torch.int32)
    drops = getattr(_drops, "out", None)
    if drops is not None:
        drops.append(n - placed.sum())
    return torch.clamp(pos, max=C - 1), keep, flat[:E * C].view(E, C), count


def aux_load_balance_loss(x, router, cfg, mesh=None, gates=None):
    """Switch/GShard router losses of tokens x (T, d): load balance
    (E · sum_e f_e P_e, f_e the share of the T K assignments routed to
    expert e, P_e its mean router probability) plus 1e-3 x the z-loss
    (the mean squared logsumexp of the gates), as the reference.  The
    counts f carry no gradient.  Under a ``mesh`` whose batch axes split
    the batch, f and P are the global batch's, as the reference's GSPMD
    step computes them: their sums are all-reduced over the batch axes
    (P's gradient too, since each data rank's loss holds the one global
    term); the z-loss is a mean of equal shards' means.  ``gates``: the
    router's logits, already computed (:func:`router_gates`)."""
    E, K = cfg.n_experts, cfg.top_k
    if gates is None:
        gates = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(gates, dim=-1)  # (T, E)
    _, ids = top_k(probs, K)
    T = x.shape[0]
    ones = torch.ones(ids.numel(), dtype=torch.float32, device=x.device)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, ids.reshape(-1), ones)
    bax = batch_axes(mesh) if mesh is not None else None
    if bax and mesh.size(bax) > 1:
        n = mesh.size(bax)
        counts = mesh.all_reduce(counts, bax)
        P = reduce_from(copy_to(probs.sum(dim=0), mesh, bax), mesh, bax) / (T * n)
        f = counts / (T * n * K)
    else:
        f, P = counts / (T * K), probs.mean(dim=0)
    lb = E * torch.sum(f * P)
    z = torch.mean(torch.square(torch.logsumexp(gates, dim=-1)))
    return lb + 1e-3 * z


def moe_ffn(x, p, cfg, impl=None):
    """x (T, d) flat tokens -> (T, d): route, dispatch into the capacity
    buffer's row map, the experts' SwiGLU, combine."""
    E, K, impl = cfg.n_experts, cfg.top_k, impl or cfg.kernel_impl
    fids, fw, tok = route(x, p["router"], E, K, impl)
    return dispatch_compute_combine(x, fids, fw, tok, p["experts"], E,
                                    capacity(x.shape[0], cfg), K, impl)


def moe_ffn_ep(h, p, cfg, impl=None, mesh=None):
    """The expert-parallel MoE of tokens h (B, S, d) on a model rank that
    holds ``p["experts"]``'s E/par experts (the reference's shard_map
    ``local_fn``): route every token, keep the rank's own assignments, send
    the rest to local expert 0 at weight 0 (they take capacity slots there,
    drops included, as the reference's), run the local experts, and sum the
    ranks' partial outputs over "model".  The capacity is the reference's,
    of the rank's T tokens and all E experts.  Under autograd the tokens
    and the router, which every model rank uses for its part of one sum,
    take the sum of the ranks' cotangents, and the summed output passes
    its cotangent through (:func:`distributed.sharding.copy_to`,
    :func:`reduce_from`)."""
    mesh = mesh or current_mesh()
    E, K, impl = cfg.n_experts, cfg.top_k, impl or cfg.kernel_impl
    b, s, d = h.shape
    e_loc = E // mesh.shape["model"]
    rank = mesh.coord["model"]
    x = copy_to(h.reshape(b * s, d), mesh, ("model",))
    fids, fw, tok = route(x, copy_to(p["router"], mesh, ("model",)), E, K, impl)
    mine = torch.div(fids, e_loc, rounding_mode="floor") == rank
    fw = torch.where(mine, fw, torch.zeros_like(fw))
    fids = torch.where(mine, fids - rank * e_loc, torch.zeros_like(fids))
    out = dispatch_compute_combine(x, fids, fw, tok, p["experts"], e_loc,
                                   capacity(x.shape[0], cfg), K, impl)
    return reduce_from(out, mesh, ("model",)).reshape(b, s, d)


def moe_ffn_tp(x, p, cfg, impl, mesh, gates):
    """The tensor-parallel MoE of tokens x (T, d) on a model rank that
    holds E/par of the experts and whose router logits ``gates`` (T, E)
    are whole (:func:`router_gates`): the reference's routing and
    whole-buffer dispatch, its capacity and drops, on every rank; then the
    rank's experts' rows of the buffer on ``moe_gemm``, the combine of the
    assignments they hold, and the sum over "model"."""
    E, K = cfg.n_experts, cfg.top_k
    e_loc = p["experts"]["w_up"].shape[0]
    lo = model_offset(e_loc, mesh)
    fids, fw, tok = route(x, None, E, K, gates=gates)
    slot, keep, rows, count = dispatch(fids, fw, tok, E, capacity(x.shape[0], cfg))
    moe_gemm = _moe_gemm(impl)
    ex = p["experts"]
    x = copy_to(x, mesh, MODEL)
    h = moe_gemm(x, ex["w_gate"], count[lo:lo + e_loc], rows[lo:lo + e_loc], ex["w_up"])
    y = moe_gemm(h, ex["w_down"], count[lo:lo + e_loc])
    mine = keep & (fids >= lo) & (fids < lo + e_loc)
    w = copy_to(fw, mesh, MODEL) * mine.to(fw.dtype)
    y_tok = (y[torch.clamp(fids - lo, 0, e_loc - 1), slot] * w[:, None]).view(-1, K, x.shape[1])
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + y_tok[:, k]
    return reduce_from(out, mesh, MODEL)


def _moe_gemm(impl: str):
    if impl == "cuda":
        from repro_torch.kernels.ops import moe_gemm

        return moe_gemm
    return moe_gemm_plain


def use_ep(cfg, mesh=None) -> bool:
    """Expert parallelism is on: ``cfg.ep_shard_map`` under a mesh whose
    "model" axis divides the experts."""
    mesh = mesh or current_mesh()
    return bool(cfg.ep_shard_map and mesh is not None and "model" in mesh.axis_names
                and cfg.n_experts % mesh.shape["model"] == 0)


def dispatch_compute_combine(x, fids, fw, tok, ex, E: int, C: int, K: int, impl: str):
    """The reference's ``_dispatch_compute_combine`` of tokens x (T, d)
    over experts ``ex`` (E of them): place the assignments into the
    capacity buffer's row map, run the experts' SwiGLU on ``moe_gemm``
    (its plain version unless ``impl`` is ``"cuda"``), and combine each
    token's K rows by their weights."""
    slot, keep, rows, count = dispatch(fids, fw, tok, E, C)
    moe_gemm = _moe_gemm(impl)
    h = moe_gemm(x, ex["w_gate"], count, rows, ex["w_up"])
    y = moe_gemm(h, ex["w_down"], count)
    y_tok = (y[fids, slot] * (fw * keep.to(fw.dtype))[:, None]).view(-1, K, x.shape[1])
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + y_tok[:, k]
    return out


def moe_block_apply(p, x, positions, cfg, *, mode, cache, pos=None):
    impl = L.impl_for(cfg, mode)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps, impl)
    if mode == "train":
        a = A.attend_full(p["attn"], h, positions, cfg)
    elif mode == "prefill":
        a, cache = A.prefill_with_cache(p["attn"], h, positions, cfg, cache)
    elif mode == "decode":
        a, cache = A.decode_step(p["attn"], h, pos, cfg, cache)
    elif mode == "chunk":  # mixed-phase prefill chunk; pos = (posv, valid)
        posv, valid = pos
        a, cache = A.chunk_step(p["attn"], h, posv, valid, cfg, cache)
    else:
        raise ValueError(f"mode {mode!r} is not train, prefill, decode or chunk")
    x = x + a
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps, impl)
    b, s, d = h.shape
    mesh = current_mesh()
    flat, gates = h.reshape(b * s, d), None
    if use_ep(cfg, mesh):
        ff = moe_ffn_ep(h, p, cfg, impl, mesh)
    elif (tp := L.sliced(p["experts"]["w_up"].shape[0], cfg.n_experts)) is not None:
        gates = router_gates(flat, p["router"], cfg.n_experts, impl)
        ff = moe_ffn_tp(flat, p, cfg, impl, tp, gates).reshape(b, s, d)
    else:
        ff = moe_ffn(flat, p, cfg, impl).reshape(b, s, d)
    if cfg.dense_residual:
        dm = p["dense_mlp"]
        ff = ff + L.swiglu(h, dm["w_gate"], dm["w_up"], dm["w_down"], impl, cfg.d_ff)
    if mode == "train":
        return x + ff, aux_load_balance_loss(flat, p["router"], cfg, mesh, gates)
    return x + ff, cache


@contextlib.contextmanager
def dropped_assignments():
    """Collect, on this thread, the number of assignments each MoE layer
    call drops (capacity overflow) as 0-d device tensors, in call order:
    no host sync inside.  For eager runs: a graph's replay adds nothing."""
    prev, _drops.out = getattr(_drops, "out", None), []
    try:
        yield _drops.out
    finally:
        _drops.out = prev
