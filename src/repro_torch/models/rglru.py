"""RecurrentGemma (Griffin) hybrid stack: RG-LRU recurrent blocks + local
attention in a repeating ``block_pattern`` (rec, rec, attn).

The 26-layer stack keeps the JAX package's parameter tree: 8 full
(rec, rec, attn) units stacked along a leading dim under ``units``, plus an
unstacked 2-layer (rec, rec) ``tail``.  The JAX ``lax.scan`` over units
becomes a loop over per-unit views; caches are written in place.

RG-LRU recurrence (diagonal, gated):
    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
Gates are block-diagonal with n_heads blocks (as in the paper).

Training (``forward_train``, ``mode="train"``) has no cache: the conv and
the recurrence start from zeros, the products, norms and scans are the
reference's (``layers.impl_for``), and ``cfg.remat`` checkpoints each full
unit, as the reference remats its scanned unit body (the tail runs plain).

Tensor parallelism over "model": a rank holds ``w/par`` of the recurrent
width of ``in_x``, ``in_y``, the conv, ``lam``, ``out`` (row-parallel) and
both caches, and ``rglru_scan`` runs on those channels.  The gates are
block-diagonal over ``n_heads`` blocks: where the rank's channels are
whole blocks, one ``gemm_rowinv`` launch over its blocks of ``gate_a``,
``gate_x`` and their biases, taken from the whole leaves; where a block
straddles two ranks (``n_heads`` not a multiple of the degree), the
conv's output is gathered whole and every block computed, then cut to the
rank's channels.  ``gate_a`` is held whole (:data:`HELD_WHOLE`).  The
attention layers are MQA (10 heads over 1 kv head): the qheads scheme.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import MODEL, copy_to, gather_from, model_offset
from repro_torch.kernels.rglru_scan import rglru_scan_plain
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.params import Spec, cast_float, stack_layers, unstack

LRU_C = 8.0
CHUNK = 256

# The leaves a model rank holds whole although the reference slices them
# over "model", with the reason.
HELD_WHOLE = {
    "gate_a": "the reference slices each block's output columns (nb, bw, bw/par), while "
              "in_x, in_y and the conv slice the width across blocks and gate_x stays "
              "whole: each rank takes its blocks (or, misaligned, every block) of the whole "
              "leaf instead",
}


def _pattern_layout(cfg):
    """(n_full_units, tail_types) for the repeating block pattern."""
    pat = cfg.block_pattern
    n_units = cfg.n_layers // len(pat)
    tail = tuple(pat[: cfg.n_layers % len(pat)])
    return n_units, tail


# ------------------------------------------------------------ rec block


def rec_block_spec(cfg, par: int = 1) -> dict:
    d, w, nb = cfg.d_model, cfg.lru_width, max(cfg.n_heads, 1)
    bw = w // nb
    m = "model" if par > 1 and w % par == 0 else None
    return {
        "norm": Spec((d,), "ones", pspec=(None,)),
        "in_x": Spec((d, w), pspec=(None, m)),
        "in_y": Spec((d, w), pspec=(None, m)),
        "conv_w": Spec((w, 4), "small_normal", 0.1, pspec=(m, None)),
        "conv_b": Spec((w,), "zeros", pspec=(m,)),
        "gate_a": Spec((nb, bw, bw),
                       pspec=(None, None, m if bw % max(par, 1) == 0 else None)),
        "gate_x": Spec((nb, bw, bw), pspec=(None, None, None)),
        "gate_a_b": Spec((nb, bw), "zeros", pspec=(None, None)),
        "gate_x_b": Spec((nb, bw), "zeros", pspec=(None, None)),
        "lam": Spec((w,), "lambda_init", pspec=(m,)),
        "out": Spec((w, d), pspec=(m, None)),
    }


def rec_cache_spec(cfg, batch: int, par: int = 1) -> dict:
    w = cfg.lru_width
    m = "model" if par > 1 and w % par == 0 else None
    return {
        "conv": Spec((batch, 3, w), "zeros", pspec=("batch", None, m)),
        "h": Spec((batch, w), "zeros", pspec=("batch", m)),
    }


def _rglru_scan(a, b, h0, impl: str = "reference"):
    """h_t = a_t h_{t-1} + b_t, diagonal.  S == 1 is one elementwise step;
    ``"cuda"`` with any other S is the ``rglru_scan`` kernel, which needs no
    divisibility of S; ``"reference"`` takes a log-step scan within each
    chunk of min(256, S) steps where S is a multiple of it, and
    ``rglru_scan_plain``, a loop over time, for any other S."""
    bsz, s, w = a.shape
    chunk = min(CHUNK, s)
    if s == 1:
        h = a[:, 0] * h0 + b[:, 0]
        return h[:, None], h
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.rglru_scan(a, b, h0.contiguous())
    if s % chunk == 0:
        h, hs = h0, []
        for c0 in range(0, s, chunk):
            a_s, b_s = L.assoc_scan(a[:, c0:c0 + chunk], b[:, c0:c0 + chunk])
            hs.append(a_s * h[:, None] + b_s)
            h = hs[-1][:, -1]
        return torch.cat(hs, dim=1), h
    return rglru_scan_plain(a, b, h0)


def _gates(p, xc, cfg, impl, mesh):
    """The recurrence's gates r and i (float32, as xc (B, S, w)) on the
    rank's ``w`` channels: sigmoid of the block-diagonal products of
    ``xc`` with ``gate_a`` and ``gate_x`` (whole leaves, as their biases).
    On a model rank whose channels are whole blocks, its blocks; where
    blocks straddle ranks, every block of the gathered ``xc``, cut to the
    rank's channels."""
    bsz, s, w = xc.shape
    bw = p["gate_x"].shape[1]
    leaves = [p[k] for k in ("gate_a", "gate_a_b", "gate_x", "gate_x_b")]
    lo = 0
    if mesh is not None:
        lo = model_offset(w, mesh)
        if w % bw == 0:  # whole blocks
            leaves = [copy_to(t, mesh, MODEL).narrow(0, lo // bw, w // bw) for t in leaves]
        else:
            xc = gather_from(xc, mesh, MODEL, -1)
    ga, gab, gx, gxb = leaves
    xg = xc.reshape(bsz, s, -1, bw)
    r = torch.sigmoid(L.linear(xg, ga, impl, gab)).reshape(bsz, s, -1).float()
    i = torch.sigmoid(L.linear(xg, gx, impl, gxb)).reshape(bsz, s, -1).float()
    if r.shape[-1] != w:
        r, i = (copy_to(t, mesh, MODEL).narrow(-1, lo, w) for t in (r, i))
    return r, i


def rec_block_apply(p, x, cfg, cache, impl=None):
    """Griffin recurrent block; ``cache`` ({conv, h}) is updated in place
    (None: from zeros, nothing kept).  Returns (x, cache)."""
    bsz, s, _ = x.shape
    w = p["lam"].shape[0]  # the rank's channels of the width
    mesh = L.sliced(w, cfg.lru_width)
    impl = impl or cfg.kernel_impl
    h = copy_to(L.rms_norm(x, p["norm"], cfg.norm_eps, impl), mesh, MODEL)
    y_branch = F.gelu(L.linear(h, p["in_y"], impl), approximate="tanh")  # (B,S,w)
    x_branch = L.linear(h, p["in_x"], impl)

    # Causal depthwise conv (width 4) over the carried state and the input.
    ck = p["conv_w"].shape[1]
    if cache is not None:
        conv_in = torch.cat([cache["conv"].to(x_branch.dtype), x_branch], dim=1)
    else:
        conv_in = F.pad(x_branch, (0, 0, ck - 1, 0))
    xc = sum(conv_in[:, i: i + s] * p["conv_w"][:, i] for i in range(ck)) + p["conv_b"]

    # Block-diagonal gates: each one product of the nb blocks, one launch
    # under the kernels (the JAX package unrolls them per block to keep its
    # CPU lowering batch-invariant; the row-invariant GEMM is so by
    # construction).
    r, i = _gates(p, xc, cfg, impl, mesh)
    log_a = -LRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * i * xc.float()
    h0 = (cache["h"].float() if cache is not None
          else torch.zeros((bsz, w), dtype=torch.float32, device=x.device))
    hs, h_last = _rglru_scan(a, gated, h0, impl=impl)

    out = L.row_parallel(hs.to(x.dtype) * y_branch, p["out"], impl, mesh)
    if cache is not None:
        cache["conv"].copy_(conv_in[:, -(ck - 1):])
        cache["h"].copy_(h_last)
    return x + out, cache


# ----------------------------------------------------------- mlp + attn


def mlp_spec(cfg, par: int = 1) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": Spec((d,), "ones", pspec=(None,)),
        "w_gate": Spec((d, f), pspec=(None, "model")),
        "w_up": Spec((d, f), pspec=(None, "model")),
        "w_down": Spec((f, d), pspec=("model", None)),
    }


def layer_spec(cfg, kind: str, par: int = 1) -> dict:
    if kind == "rec":
        return {"mix": rec_block_spec(cfg, par), "mlp": mlp_spec(cfg, par)}
    return {
        "mix": {"norm": Spec((cfg.d_model,), "ones", pspec=(None,)), **A.attn_spec(cfg, par)},
        "mlp": mlp_spec(cfg, par),
    }


def layer_cache_spec(cfg, batch: int, max_seq: int, kind: str, par: int = 1) -> dict:
    if kind == "rec":
        return rec_cache_spec(cfg, batch, par)
    return A.cache_spec(cfg, batch, max_seq, par, window=cfg.window)


def layer_apply(p, x, positions, cfg, *, kind, mode, cache, pos=None):
    """One layer of either kind; its cache is updated in place (``mode``
    "train": no cache)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r} is not train, prefill or decode")
    impl = L.impl_for(cfg, mode)
    if kind == "rec":
        x, _ = rec_block_apply(p["mix"], x, cfg, cache, impl)
    else:
        ap = {k: v for k, v in p["mix"].items() if k != "norm"}
        h = L.rms_norm(x, p["mix"]["norm"], cfg.norm_eps, impl)
        if mode == "train":
            a = A.attend_full(ap, h, positions, cfg, window=cfg.window)
        elif mode == "prefill":
            a, _ = A.prefill_with_cache(ap, h, positions, cfg, cache, window=cfg.window)
        else:
            a, _ = A.decode_step(ap, h, pos, cfg, cache, window=cfg.window)
        x = x + a
    h = L.rms_norm(x, p["mlp"]["norm"], cfg.norm_eps, impl)
    x = x + L.geglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"], impl,
                    cfg.d_ff)
    return x, cache


# -------------------------------------------------------------- stack


def param_spec(cfg, par: int = 1) -> dict:
    from repro_torch.models import transformer as T

    n_units, tail = _pattern_layout(cfg)
    spec = T.embed_spec(cfg, par)
    unit = {f"l{i}_{k}": layer_spec(cfg, k, par) for i, k in enumerate(cfg.block_pattern)}
    spec["units"] = stack_layers(n_units, unit)
    spec["tail"] = {f"t{i}_{k}": layer_spec(cfg, k, par) for i, k in enumerate(tail)}
    return spec


def cache_spec(cfg, batch: int, max_seq: int, par: int = 1) -> dict:
    n_units, tail = _pattern_layout(cfg)
    unit = {f"l{i}_{k}": layer_cache_spec(cfg, batch, max_seq, k, par)
            for i, k in enumerate(cfg.block_pattern)}
    return {
        "units": stack_layers(n_units, unit),
        "tail": {f"t{i}_{k}": layer_cache_spec(cfg, batch, max_seq, k, par)
                 for i, k in enumerate(tail)},
    }


def model_sliced(cfg, mesh) -> dict:
    """The whole key paths of the leaves a model rank of ``mesh`` holds a
    slice of: every leaf with a "model" entry in the reference's specs --
    the vocabulary of the tied ``embed``, the rec blocks' width, the MLPs'
    hidden width, the attention leaves by ``attention.scheme``, the rec
    caches' width and the attention caches (their timeline under the
    seq-sharded decode) -- less each rec block's ``gate_a``
    (:data:`HELD_WHOLE`)."""
    from repro_torch.distributed.sharding import model_paths
    from repro_torch.launch.mesh import model_par

    par = model_par(mesh)
    whole = tuple(f"/mix/{k}" for k in HELD_WHOLE)
    params = tuple(p for p in model_paths(param_spec(cfg, par)) if not p.endswith(whole))
    # At a cache length the degree divides, where the seq-sharded layout
    # has its "model" entries.
    return {"params": params, "cache": model_paths(cache_spec(cfg, 1, par, par))}


def stack_order(params, cache, cfg):
    """(layer apply, layer params, layer cache) of every layer in the order
    the stack runs them (units, then the tail), as views into the trees;
    the apply is ``layer_apply`` with the layer's kind bound."""
    n_units, tail = _pattern_layout(cfg)
    layers = []
    for up, uc in zip(unstack(params["units"], n_units), unstack(cache["units"], n_units)):
        layers += [(k, up[f"l{i}_{k}"], uc[f"l{i}_{k}"]) for i, k in enumerate(cfg.block_pattern)]
    layers += [(k, params["tail"][f"t{i}_{k}"], cache["tail"][f"t{i}_{k}"])
               for i, k in enumerate(tail)]
    return [(functools.partial(layer_apply, kind=k), lp, lc) for k, lp, lc in layers]


def run_stack(params, x, positions, cfg, *, mode, cache, pos=None):
    """Run the layer stack; the cache is updated in place.  Returns
    (x, cache)."""
    if mode == "train":
        return _train_stack(params, x, positions, cfg), None
    for apply, lp, lc in stack_order(params, cache, cfg):
        x, _ = apply(lp, x, positions, cfg, mode=mode, cache=lc, pos=pos)
    return x, cache


def _train_stack(params, x, positions, cfg):
    """The train mode's stack (:func:`train_layers`)."""
    for fn, lp in train_layers(params, positions, cfg):
        x, _ = fn(lp, x)
    return x


def train_layers(params, positions, cfg, prefix_len: int = 0) -> list:
    """The train mode's stack as (fn, params) pairs in the order it runs
    them, ``fn(p, x) -> (x, 0.0)``: each full unit under ``remat``, then
    the tail's layers one by one (``prefix_len``: none in this family)."""
    from repro_torch.models import transformer as T

    def unit(up, h):
        for i, kind in enumerate(cfg.block_pattern):
            h, _ = layer_apply(up[f"l{i}_{kind}"], h, positions, cfg, kind=kind,
                               mode="train", cache=None)
        return h

    def layer(kind):
        return lambda lp, h: (layer_apply(lp, h, positions, cfg, kind=kind, mode="train",
                                          cache=None)[0], 0.0)

    n_units, tail = _pattern_layout(cfg)
    body = T.remat(unit, cfg)
    out = [(lambda up, h: (body(up, h), 0.0), up) for up in unstack(params["units"], n_units)]
    return out + [(layer(kind), params["tail"][f"t{i}_{kind}"]) for i, kind in enumerate(tail)]


def forward_train(params, batch, cfg):
    """The scalar next-token loss of ``batch`` ({tokens (B, S)}); the
    float parameters cast to the compute dtype once (see
    ``transformer.forward_train``)."""
    from repro_torch.models import transformer as T

    params = cast_float(params, cfg.compute_dtype)
    x, positions, _ = T.train_input(params, batch, cfg)
    x, _ = run_stack(params, x, positions, cfg, mode="train", cache=None)
    return T.train_loss(params, x, 0.0, batch["tokens"], cfg)


def prefill(params, batch, cfg, cache):
    from repro_torch.models import transformer as T

    tokens = batch["tokens"]
    b, s = tokens.shape
    x = T.embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    x, cache = run_stack(params, x, positions, cfg, mode="prefill", cache=cache)
    return T.logits_fn(params, x[:, -1:], cfg), cache


def decode(params, token, pos, cfg, cache):
    """One decode step; ``pos`` is a scalar or a (B,) per-slot vector."""
    from repro_torch.models import transformer as T

    x = T.embed_tokens(params, token, cfg)
    posv = A.pos_vector(pos, token.shape[0], token.device)
    x, cache = run_stack(params, x, posv[:, None], cfg, mode="decode", cache=cache, pos=posv)
    return T.logits_fn(params, x, cfg), cache
