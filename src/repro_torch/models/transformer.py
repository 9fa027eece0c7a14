"""Decoder LM of the dense, moe and ssm families: the layer stack, embed and
head.

Parameters keep the JAX package's tree: per-layer leaves stacked along a
leading ``n_layers`` dim.  The JAX ``lax.scan`` over layers becomes a loop
over per-layer views of the stacked tensors; the stacked cache is written in
place through the same views.

Block interface (as in the JAX package):
    block_spec(cfg) -> Spec tree for ONE layer
    block_apply(p, x, positions, cfg, *, mode, cache, pos) -> (x, cache)

The moe family (arctic, kimi-k2) swaps the block for ``moe.py``'s, which
keeps the dense block's attention and cache; the ssm family (falcon-mamba)
for ``mamba.py``'s.  The vlm family (paligemma) is the dense stack behind a
prefix of ``n_patches`` image-patch embeddings, which its prefill attends
with the prefix-LM mask.  The dense and moe families also run chunked
prefill (``mode="chunk"``, :func:`prefill_chunk`).  Training is not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba, moe
from repro_torch.models.params import Spec, stack_layers, tree_map


# ------------------------------------------------------------- dense block


def dense_block_spec(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "attn": A.attn_spec(cfg),
        "mlp": {
            "w_gate": Spec((d, f)),
            "w_up": Spec((d, f)),
            "w_down": Spec((f, d)),
        },
        "norm1": Spec((d,), "ones"),
        "norm2": Spec((d,), "ones"),
    }


def dense_block_apply(p, x, positions, cfg, *, mode, cache, pos=None, prefix_len=0):
    impl = cfg.kernel_impl
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps, impl)
    if mode == "prefill":
        a, cache = A.prefill_with_cache(p["attn"], h, positions, cfg, cache,
                                        window=cfg.window, prefix_len=prefix_len)
    elif mode == "decode":
        a, cache = A.decode_step(p["attn"], h, pos, cfg, cache, window=cfg.window)
    elif mode == "chunk":  # mixed-phase prefill chunk; pos = (posv, valid)
        posv, valid = pos
        a, cache = A.chunk_step(p["attn"], h, posv, valid, cfg, cache, window=cfg.window)
    else:
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    x = x + a
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps, impl)
    x = x + L.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"], impl)
    return x, cache


def dense_cache_spec(cfg, batch: int, max_seq: int) -> dict:
    return A.cache_spec(cfg, batch, max_seq, window=cfg.window)


# ---------------------------------------------------------------- stack


# (block_spec, block_apply, per-layer cache_spec) of each family this stack
# serves.
FAMILIES = {
    "dense": (dense_block_spec, dense_block_apply, dense_cache_spec),
    "moe": (moe.moe_block_spec, moe.moe_block_apply, dense_cache_spec),
    "vlm": (dense_block_spec, dense_block_apply, dense_cache_spec),
    "ssm": (mamba.mamba_block_spec, mamba.mamba_block_apply,
            lambda cfg, batch, max_seq: mamba.ssm_cache_spec(cfg, batch)),
}


def embed_spec(cfg) -> dict:
    spec = {
        "embed": Spec((cfg.vocab, cfg.d_model), "small_normal", 0.02),
        "final_norm": Spec((cfg.d_model,), "ones"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = Spec((cfg.d_model, cfg.vocab))
    return spec


def param_spec(cfg) -> dict:
    spec = embed_spec(cfg)
    bspec, _, _ = FAMILIES[cfg.family]
    spec["layers"] = stack_layers(cfg.n_layers, bspec(cfg))
    return spec


def cache_spec(cfg, batch: int, max_seq: int) -> dict:
    """Stacked (n_layers-leading) cache tree."""
    _, _, layer_cache_spec = FAMILIES[cfg.family]
    return stack_layers(cfg.n_layers, layer_cache_spec(cfg, batch, max_seq))


def stack_order(params, cache, cfg):
    """(block apply, layer params, layer cache) of every layer in the
    order the stack runs them, as views into the stacked trees."""
    _, bapply, _ = FAMILIES[cfg.family]
    return [(bapply, tree_map(lambda a: a[i], params["layers"]),
             tree_map(lambda a: a[i], cache)) for i in range(cfg.n_layers)]


def run_stack(params, x, positions, cfg, *, mode, cache, pos=None, prefix_len=0):
    """Run the layer stack; the stacked cache is updated in place.
    ``prefix_len`` (the vlm family's prefill) reaches the dense blocks.
    Returns (x, cache)."""
    kw = {"prefix_len": prefix_len} if prefix_len else {}
    for apply, lp, lc in stack_order(params, cache, cfg):
        x, _ = apply(lp, x, positions, cfg, mode=mode, cache=lc, pos=pos, **kw)
    return x, cache


# ------------------------------------------------------------ embed/head


def embed_tokens(params, tokens, cfg):
    x = params["embed"][tokens.long()].to(getattr(torch, cfg.compute_dtype))
    if cfg.tie_embeddings:
        x = x * (cfg.d_model ** 0.5)  # gemma-style scaling
    return x


def logits_fn(params, x, cfg):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.kernel_impl)
    # A tied head reads the embedding table as it is stored: (vocab, d)
    # row-major is the transposed (N, K) layout the GEMM takes.
    head = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T
    return L.linear(x, head.to(x.dtype), cfg.kernel_impl).float()


# ------------------------------------------------------------- public API


def prefill(params, batch, cfg, cache):
    """Fill the cache from a full prompt; returns (last_logits, cache).  The
    vlm family's prompt is ``batch["patches"]`` (B, n_patches, d) followed
    by the embedded tokens, at positions 0 .. n_patches + S - 1."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    prefix_len = 0
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        prefix_len, s = cfg.n_patches, x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    x, cache = run_stack(params, x, positions, cfg, mode="prefill", cache=cache,
                         prefix_len=prefix_len)
    return logits_fn(params, x[:, -1:], cfg), cache


def prefill_chunk(params, tokens, posv, valid, cfg, cache, last_idx):
    """Advance mixed-phase prefill cursors by one chunk (chunked prefill:
    some slots of the batch may be decoding instead; their rows arrive
    fully masked).  tokens: (B, L) prompt slice per slot; posv: (B,)
    cursor base positions; valid: (B, L) row mask (False past the slot's
    prompt end); last_idx: (B,) row of each slot's final prompt position
    within this chunk (clipped: only meaningful for slots whose prompt
    completes here).  Returns (logits (B, 1, V) at ``last_idx``, cache):
    the logits row is the slot's first generated token's distribution,
    bitwise ``prefill``'s last-row logits."""
    x = embed_tokens(params, tokens, cfg)
    x, cache = run_stack(params, x, None, cfg, mode="chunk", cache=cache, pos=(posv, valid))
    x_last = x[torch.arange(x.shape[0], device=x.device), last_idx.long()][:, None]
    return logits_fn(params, x_last, cfg), cache


def decode(params, token, pos, cfg, cache):
    """One decode step. token: (B, Sq) int; pos: scalar or a (B,) vector of
    per-slot positions (Sq > 1: rows at pos .. pos+Sq-1)."""
    x = embed_tokens(params, token, cfg)
    x, cache = run_stack(params, x, None, cfg, mode="decode", cache=cache, pos=pos)
    return logits_fn(params, x, cfg), cache
