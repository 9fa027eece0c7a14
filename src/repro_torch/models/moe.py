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
:func:`aux_load_balance_loss` in its cache's place.  The expert-parallel
``moe_ffn_ep`` is not ported (ROADMAP.md A11).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels.moe_gemm import moe_gemm_plain
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.params import Spec

CAPACITY_FACTOR = 1.25

_drops = threading.local()


def moe_block_spec(cfg) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    spec = {
        "attn": A.attn_spec(cfg),
        "router": Spec((d, E), "small_normal", 0.02),
        "experts": {
            "w_gate": Spec((E, d, f)),
            "w_up": Spec((E, d, f)),
            "w_down": Spec((E, f, d)),
        },
        "norm1": Spec((d,), "ones"),
        "norm2": Spec((d,), "ones"),
    }
    if cfg.dense_residual:
        spec["dense_mlp"] = {
            "w_gate": Spec((d, f)),
            "w_up": Spec((d, f)),
            "w_down": Spec((f, d)),
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


def route(x, router, E: int, K: int, impl: str = "reference"):
    """Top-k routing of tokens x (T, d).  Returns the flat expert ids
    (T K,), their weights in x's dtype (renormalised over each token's K)
    and each assignment's token."""
    gates = L.linear(x, router.to(x.dtype), impl).float()
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


def aux_load_balance_loss(x, router, cfg):
    """Switch/GShard router losses of tokens x (T, d): load balance
    (E · sum_e f_e P_e, f_e the share of the T K assignments routed to
    expert e, P_e its mean router probability) plus 1e-3 x the z-loss
    (the mean squared logsumexp of the gates), as the reference.  The
    counts f carry no gradient."""
    E, K = cfg.n_experts, cfg.top_k
    gates = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(gates, dim=-1)  # (T, E)
    _, ids = top_k(probs, K)
    T = x.shape[0]
    ones = torch.ones(ids.numel(), dtype=torch.float32, device=x.device)
    f = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, ids.reshape(-1), ones) / (T * K)
    lb = E * torch.sum(f * probs.mean(dim=0))
    z = torch.mean(torch.square(torch.logsumexp(gates, dim=-1)))
    return lb + 1e-3 * z


def moe_ffn(x, p, cfg, impl=None):
    """x (T, d) flat tokens -> (T, d): route, dispatch into the capacity
    buffer's row map, the experts' SwiGLU, combine."""
    E, K, impl = cfg.n_experts, cfg.top_k, impl or cfg.kernel_impl
    C = capacity(x.shape[0], cfg)
    fids, fw, tok = route(x, p["router"], E, K, impl)
    slot, keep, rows, count = dispatch(fids, fw, tok, E, C)
    ex = p["experts"]
    if impl == "cuda":
        from repro_torch.kernels.ops import moe_gemm
    else:
        moe_gemm = moe_gemm_plain
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
    ff = moe_ffn(h.reshape(b * s, d), p, cfg, impl).reshape(b, s, d)
    if cfg.dense_residual:
        dm = p["dense_mlp"]
        ff = ff + L.swiglu(h, dm["w_gate"], dm["w_up"], dm["w_down"], impl)
    if mode == "train":
        return x + ff, aux_load_balance_loss(h.reshape(b * s, d), p["router"], cfg)
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
