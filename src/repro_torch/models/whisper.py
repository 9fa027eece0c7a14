"""Whisper-tiny backbone: transformer encoder-decoder with cross-attention
(the audio family).

The counterpart of the JAX package's ``models/whisper.py``, with its keys
and layouts, so that ``params.load_jax_params`` carries a JAX tree across
unchanged.  The conv frontend is a stub there as here: the batch carries
precomputed ``frames`` (B, enc_frames, d).  Pre-LN blocks with LayerNorm
(with bias), biased q/v/out projections (k unbiased), an exact-GELU MLP,
sinusoidal encoder positions, learned decoder positions and a tied head.

Every product goes through ``layers.linear``, every norm through
``layers.layer_norm``.  Under ``kernel_impl="cuda"`` every attention runs on
a kernel: the encoder's bidirectional self-attention, the decoder's causal
prefill and its cross-attention at prefill on ``flash_attention``; the
decoder's self-attention decode on ``flash_decode`` over its cache, and its
cross-attention decode on ``flash_decode`` over ``xk``/``xv`` with every key
valid (the JAX code's dense row at Sq 1: the same function, whose rows keep
their bits at any batch).  The cache (self ``k``/``v``/``pos``, capped at
``max_decode_ctx``, and the encoder's ``xk``/``xv``) is written in place.
The head runs on the last row of a prefill only.

Training (:func:`forward_train`, the decoder's ``mode="train"``) has no
cache: the encoder, the decoder's causal self-attention over the whole
sequence and its cross-attention over the encoder's output; attention on
``flash_attention`` under ``"cuda"`` (its autograd Function), the products
and norms the reference's; the head over every position.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.distributed.sharding import MODEL, copy_to
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.params import Spec, cast_float, stack_layers, unstack


def _attn_spec(cfg, par: int = 1) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    hda = "model" if par > 1 and hd % par == 0 else None
    return {
        "wq": Spec((d, H, hd), pspec=(None, None, hda)),
        "bq": Spec((H, hd), "zeros", pspec=(None, hda)),
        "wk": Spec((d, H, hd), pspec=(None, None, hda)),
        "wv": Spec((d, H, hd), pspec=(None, None, hda)),
        "bv": Spec((H, hd), "zeros", pspec=(None, hda)),
        "wo": Spec((H, hd, d), pspec=(None, hda, None)),
        "bo": Spec((d,), "zeros", pspec=(None,)),
    }


def _ln_spec(cfg) -> dict:
    return {"w": Spec((cfg.d_model,), "ones", pspec=(None,)),
            "b": Spec((cfg.d_model,), "zeros", pspec=(None,))}


def _mlp_spec(cfg, par: int = 1) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_in": Spec((d, f), pspec=(None, "model")),
        "b_in": Spec((f,), "zeros", pspec=("model",)),
        "w_out": Spec((f, d), pspec=("model", None)),
        "b_out": Spec((d,), "zeros", pspec=(None,)),
    }


def param_spec(cfg, par: int = 1) -> dict:
    enc_layer = {"ln1": _ln_spec(cfg), "attn": _attn_spec(cfg, par), "ln2": _ln_spec(cfg),
                 "mlp": _mlp_spec(cfg, par)}
    dec_layer = {"ln1": _ln_spec(cfg), "self_attn": _attn_spec(cfg, par), "ln2": _ln_spec(cfg),
                 "cross_attn": _attn_spec(cfg, par), "ln3": _ln_spec(cfg),
                 "mlp": _mlp_spec(cfg, par)}
    return {
        "enc_layers": stack_layers(cfg.enc_layers, enc_layer),
        "enc_ln_post": _ln_spec(cfg),
        "tok_embed": Spec((cfg.vocab, cfg.d_model), "small_normal", 0.02,
                          pspec=("model", None)),
        "pos_embed": Spec((cfg.max_decode_ctx, cfg.d_model), "small_normal", 0.01,
                          pspec=(None, None)),
        "dec_layers": stack_layers(cfg.n_layers, dec_layer),
        "dec_ln_final": _ln_spec(cfg),
    }


def cache_spec(cfg, batch: int, max_seq: int, par: int = 1) -> dict:
    """Per decoder layer: the self cache ``k``/``v``/``pos`` of
    ``min(max_seq, max_decode_ctx)`` positions and the cross keys/values
    ``xk``/``xv`` of the encoder's frames."""
    H, hd = cfg.n_heads, cfg.hd
    s = min(max_seq, cfg.max_decode_ctx)
    hda = "model" if par > 1 and hd % par == 0 else None
    per_layer = {
        "k": Spec((batch, s, H, hd), "zeros", pspec=("batch", None, None, hda)),
        "v": Spec((batch, s, H, hd), "zeros", pspec=("batch", None, None, hda)),
        "pos": Spec((batch, s), "neg_ones", None, "int32", ("batch", None)),
        "xk": Spec((batch, cfg.enc_frames, H, hd), "zeros", pspec=("batch", None, None, hda)),
        "xv": Spec((batch, cfg.enc_frames, H, hd), "zeros", pspec=("batch", None, None, hda)),
    }
    return stack_layers(cfg.n_layers, per_layer)


def model_sliced(cfg, mesh) -> dict:
    """The whole key paths of the leaves a model rank of ``mesh`` holds a
    slice of: every leaf with a "model" entry -- the head dim of each
    attention's leaves and of the caches (the reference's "hd" scheme),
    the MLP's hidden width, the vocabulary of ``tok_embed`` (whole where
    the model axis does not divide it: 51865).  Its caches have no
    seq-sharded layout (:func:`cache_spec`), so the seq-sharded decode is
    refused."""
    from repro_torch.distributed.sharding import model_paths
    from repro_torch.launch.mesh import model_par

    if A.seq_mesh(cfg, mesh) is not None:
        raise ValueError("whisper's self-attention cache has no seq-sharded layout: "
                         "seq_shard_cache needs the dense, moe, vlm or hybrid family")
    par = model_par(mesh)
    return {"params": model_paths(param_spec(cfg, par)),
            "cache": model_paths(cache_spec(cfg, 1, 1, par))}


def _proj_q(p, x, impl, cfg):
    x = copy_to(x, A._sliced(p, cfg), MODEL)
    return A._proj(x, p["wq"], impl, p["bq"])


def _proj_kv(p, x, impl, cfg):
    x = copy_to(x, A._sliced(p, cfg), MODEL)
    return A._proj(x, p["wk"], impl), A._proj(x, p["wv"], impl, p["bv"])


def _attn_out(p, out, impl, cfg):
    return A._out_proj(out, p["wo"], impl, cfg, p["bo"])


def _attend(q, k, v, cfg, *, causal: bool):
    """Prefill attention: on a slice of the head dim (the "hd" scheme)
    ``attention.hd_attention``; on ``flash_attention`` at any Sq under
    ``"cuda"``; else the reference dispatch."""
    if q.shape[-1] != cfg.hd:
        return A.attend(q, k, v, cfg, causal=causal)
    if cfg.kernel_impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.flash_attention(q, k, v, causal=causal)
    return L.attention(q, k, v, cfg, causal=causal)


def _cross_decode(q, xk, xv, cfg):
    """The decode step's cross-attention over the encoder's keys: under
    ``"cuda"`` ``flash_decode`` with every key valid (key i recorded at
    position i, the query past the last), else the reference's dense row;
    on a slice of the head dim ``attention.hd_attention``."""
    if q.shape[-1] != cfg.hd:
        return A.attend(q, xk, xv, cfg, causal=False)
    if cfg.kernel_impl != "cuda":
        return L.attention(q, xk, xv, cfg, causal=False)
    from repro_torch.kernels import ops as kops

    b, f = xk.shape[0], xk.shape[1]
    kpos = torch.arange(f, dtype=torch.int32, device=q.device).expand(b, f).contiguous()
    pos = torch.full((b,), f - 1, dtype=torch.int32, device=q.device)
    return kops.flash_decode(q, xk, xv, kpos, pos, block_k=cfg.decode_block or 128)


@functools.lru_cache(maxsize=8)
def _sinusoids(length: int, channels: int, device: str):
    """The encoder's positions, computed in numpy float64 exactly as the
    JAX package does, then float32; one copy per device."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def sinusoids(length: int, channels: int, device="cpu"):
    return _sinusoids(length, channels, str(torch.device(device)))


def _enc_layer(lp, x, cfg, impl=None):
    """One encoder layer: bidirectional self-attention, then the MLP."""
    impl, eps = impl or cfg.kernel_impl, cfg.norm_eps
    h = L.layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"], eps, impl)
    q = _proj_q(lp["attn"], h, impl, cfg)
    k, v = _proj_kv(lp["attn"], h, impl, cfg)
    x = x + _attn_out(lp["attn"], _attend(q, k, v, cfg, causal=False), impl, cfg)
    m = lp["mlp"]
    h = L.layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"], eps, impl)
    return x + L.gelu_mlp(h, m["w_in"], m["b_in"], m["w_out"], m["b_out"], impl, cfg.d_ff)


def encoder_input(frames, cfg):
    """The frames in the compute dtype plus the sinusoidal positions."""
    x = frames.to(getattr(torch, cfg.compute_dtype))
    return x + sinusoids(cfg.enc_frames, cfg.d_model, x.device).to(x.dtype)


def encode(params, frames, cfg, mode="prefill"):
    """frames: (B, F, d) stubbed conv-frontend output -> (B, F, d)."""
    impl = L.impl_for(cfg, mode)
    x = encoder_input(frames, cfg)
    for lp in unstack(params["enc_layers"], cfg.enc_layers):
        x = _enc_layer(lp, x, cfg, impl)
    post = params["enc_ln_post"]
    return L.layer_norm(x, post["w"], post["b"], cfg.norm_eps, impl)


def _dec_layer(lp, h, enc_out, cfg, *, mode, cache, posv):
    """One decoder layer on its cache (written in place): ``mode`` is
    ``"prefill"`` (rows at 0..S-1, the cross keys/values from ``enc_out``),
    ``"decode"`` (one row a slot at ``posv``, the cross keys/values as
    cached) or ``"train"`` (as prefill, with no cache)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r} is not train, prefill or decode")
    impl, eps = L.impl_for(cfg, mode), cfg.norm_eps
    sa, ca = lp["self_attn"], lp["cross_attn"]
    x1 = L.layer_norm(h, lp["ln1"]["w"], lp["ln1"]["b"], eps, impl)
    q = _proj_q(sa, x1, impl, cfg)
    k, v = _proj_kv(sa, x1, impl, cfg)
    b, s = h.shape[0], h.shape[1]
    if mode == "train":
        a = _attend(q, k, v, cfg, causal=True)
    elif mode == "prefill":
        positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
        A._write(cache, positions.long(), k, v, positions)
        a = _attend(q, k, v, cfg, causal=True)
    else:
        A._write(cache, posv[:, None].long(), k, v, posv[:, None])
        self_cache = {n: cache[n] for n in ("k", "v", "pos")}
        a = A.cached_attention(q, self_cache, posv, cfg)
    h = h + _attn_out(sa, a, impl, cfg)

    x2 = L.layer_norm(h, lp["ln2"]["w"], lp["ln2"]["b"], eps, impl)
    q = _proj_q(ca, x2, impl, cfg)
    if mode != "decode":
        xk, xv = _proj_kv(ca, enc_out, impl, cfg)
        if mode == "prefill":
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
        c = _attend(q, xk, xv, cfg, causal=False)
    else:
        c = _cross_decode(q, cache["xk"].to(x2.dtype), cache["xv"].to(x2.dtype), cfg)
    h = h + _attn_out(ca, c, impl, cfg)

    m = lp["mlp"]
    x3 = L.layer_norm(h, lp["ln3"]["w"], lp["ln3"]["b"], eps, impl)
    return h + L.gelu_mlp(x3, m["w_in"], m["b_in"], m["w_out"], m["b_out"], impl, cfg.d_ff)


def decoder_input(params, tokens, cfg, pos=None):
    """(the embedded tokens plus their learned positions, the per-slot
    position vector): a prefill's rows at 0..S-1 (``pos`` None, vector
    None), or a decode step's row a slot at ``pos``."""
    b, s = tokens.shape
    x = L.embed_rows(params["tok_embed"], tokens, cfg.vocab, getattr(torch, cfg.compute_dtype))
    if pos is not None:
        # Per-slot positions: each row looks up its own positional embedding.
        posv = A.pos_vector(pos, b, tokens.device)
        pe = params["pos_embed"][posv.long()][:, None]
    else:
        posv, pe = None, params["pos_embed"][:s]
    return x + pe.to(x.dtype), posv


def _decoder(params, tokens, enc_out, cfg, *, mode, cache, pos=None):
    """The decoder stack and the tied head of its last row: (logits
    (B, 1, V) float32, cache)."""
    x, posv = decoder_input(params, tokens, cfg, pos if mode == "decode" else None)
    for lp, lc in zip(unstack(params["dec_layers"], cfg.n_layers), unstack(cache, cfg.n_layers)):
        x = _dec_layer(lp, x, enc_out, cfg, mode=mode, cache=lc, posv=posv)
    fin = params["dec_ln_final"]
    x = L.layer_norm(x[:, -1:], fin["w"], fin["b"], cfg.norm_eps, cfg.kernel_impl)
    return tied_head(params, x, cfg, cfg.kernel_impl), cache


def tied_head(params, x, cfg, impl):
    """The tied head's float32 logits of ``x``, over this model rank's
    slice of the vocabulary where it holds one of ``tok_embed``.  It reads
    the table as stored: (vocab, d) row-major is the transposed (N, K)
    layout the GEMM takes."""
    table = params["tok_embed"]
    x = copy_to(x, L.sliced(table.shape[0], cfg.vocab), MODEL)
    return L.linear(x, table.T.to(x.dtype), impl).float()


def forward_train(params, batch, cfg):
    """The scalar next-token loss of ``batch`` ({tokens (B, S), frames
    (B, enc_frames, d)}) over the tied head at every position; the float
    parameters cast to the compute dtype once (see
    ``transformer.forward_train``)."""
    params = cast_float(params, cfg.compute_dtype)
    tokens = batch["tokens"]
    enc_out = encode(params, batch["frames"], cfg, mode="train")
    x, _ = decoder_input(params, tokens, cfg)
    for lp in unstack(params["dec_layers"], cfg.n_layers):
        x = _dec_layer(lp, x, enc_out, cfg, mode="train", cache=None, posv=None)
    return train_loss(params, x, tokens, cfg)


def train_loss(params, x, tokens, cfg):
    """The next-token loss of the decoder's final hidden ``x`` (B, S, d)
    over the tied head at every position."""
    from repro_torch.models import transformer as T

    fin = params["dec_ln_final"]
    x = L.layer_norm(x, fin["w"], fin["b"], cfg.norm_eps, "reference")
    logits = tied_head(params, x, cfg, "reference")
    labels, mask = T.next_token_targets(tokens)
    return L.vocab_nll(logits, labels, mask, cfg.vocab) / torch.clamp(mask.sum(), min=1.0)


def prefill(params, batch, cfg, cache):
    """Encode ``batch["frames"]`` and prefill the decoder on
    ``batch["tokens"]``; returns (last-row logits (B, 1, V), cache)."""
    enc_out = encode(params, batch["frames"], cfg)
    return _decoder(params, batch["tokens"], enc_out, cfg, mode="prefill", cache=cache)


def decode(params, token, pos, cfg, cache):
    """One decode step. token: (B, 1) int; pos: a scalar or a (B,) vector
    of per-slot positions."""
    return _decoder(params, token, None, cfg, mode="decode", cache=cache, pos=pos)
