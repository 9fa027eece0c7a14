"""Serving steps: prefill (prompt → cache), decode (one token, KV cache),
decode *chains* (N dependent tokens, device-resident) and the chunked
prefill stage (``make_chunk_step``).

Params are cast to the compute dtype once (``cast_params_cached``) and the
cast copy is held beside the float32 masters for as long as they live: a
serving loop calls prefill/decode many times against the same parameters.

The KV cache is written in place; a cache passed to a step is updated and
returned, not copied (the JAX package donated it to the jitted step).

Tracer spans around prefill and the chain are not ported yet (ROADMAP.md
item A3).
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.models.params import tree_leaves, tree_map

# (leaf ids, dtype) -> cast tree, dropped when any source leaf is collected.
_cast_cache: dict = {}


def _cast_float(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def cast_params_cached(tree, dtype):
    """``tree`` with floating leaves cast to ``dtype``, computed once per
    (tree, dtype) and kept until a source leaf is collected."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    leaves = tree_leaves(tree)
    key = (tuple(map(id, leaves)), str(dtype))
    hit = _cast_cache.get(key)
    if hit is not None:
        return hit
    out = _cast_float(tree, dtype)
    if all(o is i for o, i in zip(tree_leaves(out), leaves)):
        # No-op cast: caching would hold strong refs to the very leaves
        # whose death is the only eviction trigger.
        return out
    for leaf in leaves:
        weakref.finalize(leaf, _cast_cache.pop, key, None)
    _cast_cache[key] = out
    return out


def _argmax_token(logits):
    return logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]


def make_prefill_step(cfg, api):
    def prefill_step(params, batch, cache):
        params = cast_params_cached(params, cfg.compute_dtype)
        logits, cache = api.prefill(params, batch, cfg, cache)
        return _argmax_token(logits), cache

    return prefill_step


def make_decode_step(cfg, api):
    """``(params, cache, token, pos) -> (token, cache)``; ``pos`` is a
    scalar or a (B,) per-slot position vector."""
    def decode_step(params, cache, token, pos):
        params = cast_params_cached(params, cfg.compute_dtype)
        logits, cache = api.decode(params, token, pos, cfg, cache)
        return _argmax_token(logits), cache

    return decode_step


def make_chunk_step(cfg, api, bucket: int, chunk_len: int):
    """One mixed-phase prefill-chunk stage over the whole batch (chunked
    prefill: the decode segment Program advances still-prefilling slots'
    cursors by ``chunk_len`` prompt tokens while other slots decode).

    ``chunk(params, cache, ptoks, pcur) -> (ctok, pcur', cache)`` where
    ``ptoks`` is the (B, bucket) padded-prompt buffer and ``pcur`` the
    (B, 1) prefill cursor (``pcur >= bucket``: the slot is decoding, all
    its rows arrive masked and its cache is untouched).  ``ctok`` is the
    argmax of the logits at each slot's final prompt row, the slot's first
    generated token, meaningful only for slots whose prefill completes this
    chunk (``pcur < bucket <= pcur'``); bitwise whole-prompt prefill's
    ``argmax(logits[:, -1])``.  Per-slot cursors stagger freely (paged
    prefix-cache hits skip whole blocks), so chunk tokens are gathered per
    slot with a clipped gather.  No host sync."""

    def chunk(params, cache, ptoks, pcur):
        params = cast_params_cached(params, cfg.compute_dtype)
        base = pcur[:, 0]  # (B,)
        positions = base[:, None] + torch.arange(chunk_len, dtype=torch.int32,
                                                 device=pcur.device)
        valid = positions < bucket
        idx = torch.clamp(positions, 0, bucket - 1).long()
        toks = torch.gather(ptoks, 1, idx)  # (B, chunk_len)
        last_idx = torch.clamp(bucket - 1 - base, 0, chunk_len - 1)
        logits, cache = api.prefill_chunk(params, toks, base, valid, cfg, cache, last_idx)
        return _argmax_token(logits), torch.clamp(pcur + chunk_len, max=bucket), cache

    return chunk


def zeros_cache(cfg, api, batch: int, max_seq: int, *, device, dtype=None):
    """Fresh empty KV cache honoring each leaf's declared init.

    The cache spec marks ``pos`` leaves ``neg_ones`` (−1 = empty slot):
    attention masks on recorded positions, so an all-zeros init would leave
    unwritten slots *valid* at position 0 and silently attend zero keys."""
    dt = getattr(torch, dtype or cfg.compute_dtype)

    def mk(s):
        ldt = getattr(torch, s.dtype) if s.dtype else dt
        if s.init == "neg_ones":
            return torch.full(s.shape, -1, dtype=ldt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=ldt, device=device)
        return torch.zeros(s.shape, dtype=ldt, device=device)

    return tree_map(mk, api.cache_spec(cfg, batch, max_seq))


def cache_batch_axes(cfg, api, max_seq: int):
    """Per-leaf batch-axis index of the cache tree (layer-stacked leaves put
    batch at axis 1, not 0).  Found structurally — the axis whose extent
    tracks the requested batch size — so it holds across model families
    without a per-family table."""
    def ax(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        raise ValueError(f"cache leaf {a.shape} has no batch axis: cannot slot it")

    return tree_map(ax, api.cache_spec(cfg, 1, max_seq), api.cache_spec(cfg, 2, max_seq))


def make_decode_chain(cfg, api):
    """Multi-step greedy decode with device-resident handoff: ``n_steps``
    dependent decode steps whose tokens, positions and KV cache stay on the
    device, with no host synchronization per token.
    ``decode_chain(params, cache, token, pos, n_steps)`` returns
    ``(tokens[b, n_steps], last_token, cache)``."""
    decode = make_decode_step(cfg, api)

    def decode_chain(params, cache, token, pos, n_steps: int):
        b = token.shape[0]
        toks = torch.empty((b, n_steps), dtype=torch.int32, device=token.device)
        posv = torch.full((b,), int(pos), dtype=torch.int32, device=token.device)
        for i in range(n_steps):
            token, cache = decode(params, cache, token, posv + i)
            toks[:, i] = token[:, 0]
        return toks, token, cache

    return decode_chain


def make_generate(cfg, api):
    """One-shot batched generate: prefill + device-resident decode chain.

    Returned ``generate(params, batch, gen, *, cache=None)`` produces
    ``(b, gen)`` greedy int32 tokens on the tokens' device; ``cache``
    defaults to a fresh ``zeros_cache`` sized ``prompt_len + gen`` (a
    caller-provided cache is consumed: written in place)."""
    prefill = make_prefill_step(cfg, api)
    chain = make_decode_chain(cfg, api)

    def generate(params, batch, gen: int, *, cache=None):
        b, s = batch["tokens"].shape
        if cache is None:
            cache = zeros_cache(cfg, api, b, s + gen, device=batch["tokens"].device)
        tok, cache = prefill(params, batch, cache)
        toks, _, _ = chain(params, cache, tok, s, gen - 1)
        return torch.cat([tok, toks], dim=1)

    return generate
