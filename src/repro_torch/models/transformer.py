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
prefill (``mode="chunk"``, :func:`prefill_chunk`).

Training (``mode="train"``, :func:`forward_train`): no cache; each block
returns its auxiliary loss (the moe family's router load balance, 0
elsewhere) in the cache's place, and the stack sums them.  The blocks'
products, norms and scans take the reference computations in that mode
(``layers.impl_for``); attention keeps ``cfg.kernel_impl``.  ``cfg.remat``
checkpoints each layer (:func:`remat`).
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.distributed.sharding import MODEL, copy_to, current_mesh, under_mesh
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba, moe
from repro_torch.models.params import Spec, cast_float, stack_layers, unstack


# ------------------------------------------------------------- dense block


def dense_block_spec(cfg, par: int = 1) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "attn": A.attn_spec(cfg, par),
        "mlp": {
            "w_gate": Spec((d, f), pspec=(None, "model")),
            "w_up": Spec((d, f), pspec=(None, "model")),
            "w_down": Spec((f, d), pspec=("model", None)),
        },
        "norm1": Spec((d,), "ones", pspec=(None,)),
        "norm2": Spec((d,), "ones", pspec=(None,)),
    }


def dense_block_apply(p, x, positions, cfg, *, mode, cache, pos=None, prefix_len=0):
    impl = L.impl_for(cfg, mode)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps, impl)
    if mode == "train":
        a = A.attend_full(p["attn"], h, positions, cfg, window=cfg.window,
                          prefix_len=prefix_len)
        cache = 0.0  # the train mode's aux-loss slot
    elif mode == "prefill":
        a, cache = A.prefill_with_cache(p["attn"], h, positions, cfg, cache,
                                        window=cfg.window, prefix_len=prefix_len)
    elif mode == "decode":
        a, cache = A.decode_step(p["attn"], h, pos, cfg, cache, window=cfg.window)
    elif mode == "chunk":  # mixed-phase prefill chunk; pos = (posv, valid)
        posv, valid = pos
        a, cache = A.chunk_step(p["attn"], h, posv, valid, cfg, cache, window=cfg.window)
    else:
        raise ValueError(f"mode {mode!r} is not train, prefill, decode or chunk")
    x = x + a
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps, impl)
    x = x + L.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"], impl,
                     cfg.d_ff)
    return x, cache


def dense_cache_spec(cfg, batch: int, max_seq: int, par: int = 1) -> dict:
    return A.cache_spec(cfg, batch, max_seq, par, window=cfg.window)


# ---------------------------------------------------------------- stack


# (block_spec, block_apply, per-layer cache_spec) of each family this stack
# serves.
FAMILIES = {
    "dense": (dense_block_spec, dense_block_apply, dense_cache_spec),
    "moe": (moe.moe_block_spec, moe.moe_block_apply, dense_cache_spec),
    "vlm": (dense_block_spec, dense_block_apply, dense_cache_spec),
    "ssm": (mamba.mamba_block_spec, mamba.mamba_block_apply,
            lambda cfg, batch, max_seq, par: mamba.ssm_cache_spec(cfg, batch, par)),
}


def embed_spec(cfg, par: int = 1) -> dict:
    spec = {
        "embed": Spec((cfg.vocab, cfg.d_model), "small_normal", 0.02, pspec=("model", None)),
        "final_norm": Spec((cfg.d_model,), "ones", pspec=(None,)),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = Spec((cfg.d_model, cfg.vocab), pspec=(None, "model"))
    return spec


def param_spec(cfg, par: int = 1) -> dict:
    """The parameters' Spec tree, with the reference's pspec entries for a
    model axis of ``par``."""
    spec = embed_spec(cfg, par)
    bspec, _, _ = FAMILIES[cfg.family]
    spec["layers"] = stack_layers(cfg.n_layers, bspec(cfg, par))
    return spec


def cache_spec(cfg, batch: int, max_seq: int, par: int = 1) -> dict:
    """Stacked (n_layers-leading) cache tree."""
    _, _, layer_cache_spec = FAMILIES[cfg.family]
    return stack_layers(cfg.n_layers, layer_cache_spec(cfg, batch, max_seq, par))


def model_sliced(cfg, mesh) -> dict:
    """The whole key paths of the leaves a model rank of ``mesh`` holds a
    slice of: every leaf with a "model" entry in the reference's specs --
    the vocabulary of ``embed`` and ``lm_head``, the attention leaves by
    ``attention.scheme``, the MLPs' hidden width, the moe family's router
    and experts (the experts alone under expert parallelism, whose router
    is whole), mamba's ``di`` channels, and the caches (their kv heads or
    head dim, or their timeline under the seq-sharded decode).  ``parts``
    names the leaves held in a layout of the port's own, each with its
    blocks: mamba's ``in_proj`` (``mamba.PARTS``)."""
    from repro_torch.distributed.sharding import model_paths
    from repro_torch.launch.mesh import model_par

    par = model_par(mesh)
    parts = {f"layers/{k}": v[0] for k, v in mamba.PARTS.items()} if cfg.family == "ssm" else {}
    # The cache at a length the degree divides, where the seq-sharded
    # layout has its "model" entries.
    return {"params": model_paths(param_spec(cfg, par)),
            "cache": model_paths(cache_spec(cfg, 1, par, par)), "parts": parts}


def stack_order(params, cache, cfg):
    """(block apply, layer params, layer cache) of every layer in the
    order the stack runs them, as views into the stacked trees (cache
    None: no cache, the train mode)."""
    _, bapply, _ = FAMILIES[cfg.family]
    n = cfg.n_layers
    caches = [None] * n if cache is None else unstack(cache, n)
    return [(bapply, lp, lc) for lp, lc in zip(unstack(params["layers"], n), caches)]


# The matrix products at the dispatcher: the outputs ``cfg.remat="dots"``
# keeps, as ``jax.checkpoint_policies.checkpoint_dots`` keeps dot_general's.
DOT_OPS = tuple(getattr(torch.ops.aten, n).default
                for n in ("mm", "bmm", "addmm", "baddbmm", "mv", "dot"))


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, cfg):
    """``fn`` under ``cfg.remat`` (the reference's ``_maybe_remat``):
    ``"full"`` keeps only its inputs and recomputes it in the backward,
    ``"dots"`` keeps the outputs of its matrix products and recomputes the
    rest (so a ``flash_attention`` forward runs again in the backward: its
    output is no product's), ``"none"`` keeps everything.  The recompute
    runs under the forward's mesh (:func:`sharding.under_mesh`): in a
    CUDA step's backward it runs on the autograd engine's device thread,
    which installed none."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r} is none of none, dots, full")
    kw = {} if cfg.remat == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_dots)}

    def run(*args, **kwargs):
        return ckpt.checkpoint(under_mesh(fn, current_mesh()), *args, use_reentrant=False,
                               **kw, **kwargs)

    return run


def train_layers(params, positions, cfg, prefix_len: int = 0) -> list:
    """The train mode's stack as (fn, layer params) pairs in the order it
    runs them, ``fn(lp, x) -> (x, aux loss)`` the layer under
    :func:`remat`: :func:`run_stack` composes them, and a layer-by-layer
    check walks the same pairs."""
    kw = {"prefix_len": prefix_len} if prefix_len else {}

    def layer(body):
        return lambda lp, x: body(lp, x, positions, cfg, mode="train", cache=None, **kw)

    return [(layer(remat(apply, cfg)), lp) for apply, lp, _ in stack_order(params, None, cfg)]


def run_stack(params, x, positions, cfg, *, mode, cache, pos=None, prefix_len=0):
    """Run the layer stack; the stacked cache is updated in place.
    ``prefix_len`` (the vlm family's prefill and training) reaches the
    dense blocks.  Returns (x, cache); in ``mode="train"`` (cache None)
    (x, the sum of the layers' aux losses), each layer under
    :func:`remat`."""
    if mode == "train":
        aux = 0.0
        for fn, lp in train_layers(params, positions, cfg, prefix_len):
            x, a = fn(lp, x)
            aux = aux + a
        return x, aux
    kw = {"prefix_len": prefix_len} if prefix_len else {}
    for apply, lp, lc in stack_order(params, cache, cfg):
        x, _ = apply(lp, x, positions, cfg, mode=mode, cache=lc, pos=pos, **kw)
    return x, cache


# ------------------------------------------------------------ embed/head


def embed_tokens(params, tokens, cfg):
    x = L.embed_rows(params["embed"], tokens, cfg.vocab, getattr(torch, cfg.compute_dtype))
    if cfg.tie_embeddings:
        x = x * (cfg.d_model ** 0.5)  # gemma-style scaling
    return x


def logits_fn(params, x, cfg, impl=None):
    """The head's float32 logits of ``x``; over this model rank's slice of
    the vocabulary where it holds one (the reference's logits stay sliced
    over "model" too)."""
    impl = impl or cfg.kernel_impl
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, impl)
    # A tied head reads the embedding table as it is stored: (vocab, d)
    # row-major is the transposed (N, K) layout the GEMM takes.
    head = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T
    x = copy_to(x, L.sliced(head.shape[1], cfg.vocab), MODEL)
    return L.linear(x, head.to(x.dtype), impl).float()


def next_token_targets(tokens):
    """(labels, mask): predict token t+1 at position t, the last position
    masked, as the reference (``jnp.roll`` wraps the first token there)."""
    labels = torch.roll(tokens, -1, dims=1).long()
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1].zero_()
    return labels, mask


def lm_loss(params, x, labels, mask, cfg):
    """Next-token cross-entropy of the final hidden ``x`` (B, S, d) on the
    reference's head; labels/mask (B, S).  ``cfg.logits_chunk`` splits the
    sequence into chunks of that many positions (when it divides S and is
    shorter), one (B, chunk, V) logits block at a time, summed in order as
    the reference's scan."""
    c, s = cfg.logits_chunk, x.shape[1]
    if c and s % c == 0 and s > c:
        tot = cnt = 0.0
        for i in range(0, s, c):
            lg = logits_fn(params, x[:, i:i + c], cfg, "reference")
            tot = tot + L.vocab_nll(lg, labels[:, i:i + c], mask[:, i:i + c], cfg.vocab)
            cnt = cnt + mask[:, i:i + c].sum()
        return tot / torch.clamp(cnt, min=1.0)
    logits = logits_fn(params, x, cfg, "reference")
    return L.vocab_nll(logits, labels, mask, cfg.vocab) / torch.clamp(mask.sum(), min=1.0)


# ------------------------------------------------------------- public API


def forward_train(params, batch, cfg):
    """The scalar train loss of ``batch`` ({tokens (B, S)}, plus the vlm
    family's patches): next-token cross-entropy, plus the moe family's
    router penalty 0.01 x (sum of the layers' aux losses) / n_layers.  The
    float parameters are cast to the compute dtype once, on the stacked
    leaves, before the per-layer views, so the gradients land on the
    float32 masters."""
    params = cast_float(params, cfg.compute_dtype)
    x, positions, prefix_len = train_input(params, batch, cfg)
    x, aux = run_stack(params, x, positions, cfg, mode="train", cache=None,
                       prefix_len=prefix_len)
    return train_loss(params, x, aux, batch["tokens"], cfg)


def train_input(params, batch, cfg):
    """(x, positions, prefix_len): the train stack's input from the cast
    ``params``, the embedded tokens behind the vlm family's patches."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    prefix_len = 0
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        prefix_len, s = cfg.n_patches, x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    return x, positions, prefix_len


def train_loss(params, x, aux, tokens, cfg):
    """The train loss of the stack's output ``x`` (the patches' rows
    dropped) and its summed aux losses ``aux``."""
    if cfg.family == "vlm":
        x = x[:, cfg.n_patches:]
    loss = lm_loss(params, x, *next_token_targets(tokens), cfg)
    if cfg.n_experts:  # MoE router load-balance penalty (Switch/GShard)
        loss = loss + 0.01 * aux / max(cfg.n_layers, 1)
    return loss


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
