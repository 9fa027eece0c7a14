"""Attention block: projections, RoPE, the contiguous KV cache.

A cache is ``{k, v, pos}``: k/v ``(B, S, KV, hd)`` and ``pos`` ``(B, S)``
int32 recorded positions, −1 for an empty slot, which makes windowed
(rolling) and full caches uniform.  Where the JAX package returns a new
cache from ``.at[].set`` on a donated buffer, the port writes the cache in
place (``index_put_``) and returns the same dict.

A cache carrying a ``"table"`` leaf is **paged**: k/v are a block pool
``(N, bl, KV, hd)`` (possibly one layer's strided view of a layer-stacked
pool), ``pos`` is ``(N, bl)``, and ``table`` ``(B, nmax)`` maps each slot's
logical tile to a physical block (see ``serve/paged.py``).

Chunked prefill (``chunk_step``, ``chunk_attention``) advances a slot's
prompt by Sq rows at consecutive positions, row-masked by ``valid``: valid
rows are written first and every row attends the cache as stored, so each
attends exactly the keys the whole-prompt prefill row at its position
would.

Under a mesh with a "model" axis of more than one rank and
``cfg.seq_shard_cache``, a contiguous cache's timeline is sharded over
"model" (:func:`seq_mesh`): each model rank holds S/par of its slots, a
cache write lands in the rank that owns its slot (slot = pos, or pos mod S
in a rolling cache; owner = slot // (S/par)), and single-row decode
attention is :func:`flash_decode_attention`, the reference's partial
softmax over the local slice merged across the ranks.  Both mesh paths
are single-row and contiguous, as the reference asserts; the servers
refuse ``seq_shard_cache``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (MODEL, copy_to, current_mesh, gather_from,
                                               model_mesh, model_offset, reduce_from)
from repro_torch.models import layers as L
from repro_torch.models.params import Spec


def scheme(cfg, par: int) -> str:
    """The reference's tensor-parallel scheme of the attention leaves over a
    model axis of ``par``: ``heads`` (q and kv heads both divide), ``qheads``
    (only q heads), ``hd`` (the head dim) or ``none``.  It sets the leaves'
    pspec entries, and a model rank holds and computes on their slices."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if par <= 1:
        return "none"
    if H % par == 0 and KV % par == 0:
        return "heads"
    if H % par == 0:
        return "qheads"
    if hd % par == 0:
        return "hd"
    return "none"


def attn_spec(cfg, par: int = 1) -> dict:
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    sc = scheme(cfg, par)
    qa = "model" if sc in ("heads", "qheads") else None
    kva = "model" if sc == "heads" else None
    hda = "model" if sc == "hd" else None
    spec = {
        "wq": Spec((d, H, hd), pspec=(None, qa, hda)),
        "wk": Spec((d, KV, hd), pspec=(None, kva, hda)),
        "wv": Spec((d, KV, hd), pspec=(None, kva, hda)),
        "wo": Spec((H, hd, d), pspec=(qa, hda, None)),
    }
    if cfg.qkv_bias:
        spec["bq"] = Spec((H, hd), "zeros", pspec=(qa, hda))
        spec["bk"] = Spec((KV, hd), "zeros", pspec=(kva, hda))
        spec["bv"] = Spec((KV, hd), "zeros", pspec=(kva, hda))
    return spec


def cache_spec(cfg, batch: int, max_seq: int, par: int = 1, window: int = 0) -> dict:
    """Per-layer KV cache. ``pos`` records absolute positions per slot (−1 =
    empty).  With ``cfg.seq_shard_cache`` and a model axis of ``par`` > 1
    that divides the cache length, the cache's timeline is sharded over
    "model" (:func:`flash_decode_attention`)."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    sc = scheme(cfg, par)
    kva = "model" if sc == "heads" else None
    hda = "model" if sc == "hd" else None
    s = min(max_seq, window) if window else max_seq
    cdt = cfg.cache_dtype or None
    if cfg.seq_shard_cache and par > 1 and s % par == 0:
        kv, pe = ("batch", "model", None, None), ("batch", "model")
    else:
        kv, pe = ("batch", None, kva, hda), ("batch", None)
    return {
        "k": Spec((batch, s, KV, hd), "zeros", None, cdt, kv),
        "v": Spec((batch, s, KV, hd), "zeros", None, cdt, kv),
        "pos": Spec((batch, s), "neg_ones", None, "int32", pe),
    }


def _proj(x, w, impl, bias=None):
    """einsum("bsd,d...->bs...", x, w) (+ bias) as one matrix product."""
    b = None if bias is None else bias.reshape(-1)
    y = L.linear(x, w.reshape(w.shape[0], -1), impl, b)
    return y.reshape(x.shape[:-1] + w.shape[1:])


def _sliced(p, cfg):
    """The model mesh when this rank holds a slice of the attention leaves
    ``p`` (q heads or the head dim), else None."""
    h, hd = p["wq"].shape[1:]
    if (h, hd) == (cfg.n_heads, cfg.hd):
        return None
    return L.sliced(h * hd, cfg.n_heads * cfg.hd)


def _rope(t, positions, cfg, mesh):
    """RoPE on q or k; on a slice of the head dim, the whole head gathered
    for the rotation's pairs and the rank's slice cut back."""
    n = t.shape[-1]
    if n == cfg.hd:
        return L.apply_rope(t, positions, cfg.rope_theta)
    whole = L.apply_rope(gather_from(t, mesh, MODEL, -1), positions, cfg.rope_theta)
    return copy_to(whole, mesh, MODEL).narrow(-1, model_offset(n, mesh), n)


def _project_qkv(p, x, positions, cfg, impl=None):
    impl = impl or cfg.kernel_impl
    mesh = _sliced(p, cfg)
    xs = copy_to(x, mesh, MODEL)
    # The qheads scheme computes k and v whole, on every rank.
    xkv = x if tuple(p["wk"].shape[1:]) == (cfg.n_kv_heads, cfg.hd) else xs
    # The bias (qwen's) is added before RoPE.
    q, k, v = (_proj(a, p[w], impl, p.get(b)) for a, w, b in
               ((xs, "wq", "bq"), (xkv, "wk", "bk"), (xkv, "wv", "bv")))
    return _rope(q, positions, cfg, mesh), _rope(k, positions, cfg, mesh), v


def _out_proj(out, wo, impl, cfg, bias=None):
    """einsum("bshk,hkd->bsd", out, wo) (+ bias) as one matrix product;
    row-parallel where the rank holds a slice of ``wo``."""
    mesh = None if tuple(wo.shape[:2]) == (cfg.n_heads, cfg.hd) else model_mesh()
    return L.row_parallel(out.flatten(2), wo.flatten(0, 1), impl, mesh, bias)


def kv_heads(hq: int, cfg, mesh):
    """The kv heads the ``hq`` q heads of this model rank read, under the
    qheads scheme: ``(first, count)`` where they are whole GQA groups or
    part of one (each kv head read by hq / count consecutive q heads), or
    a list of one kv head a q head where they straddle groups unevenly."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q0 = model_offset(hq, mesh)
    if hq % n_rep == 0 or n_rep % hq == 0:
        return q0 // n_rep, max(hq // n_rep, 1)
    return [(q0 + i) // n_rep for i in range(hq)]


# (kv heads, device) -> their index on the device: made once, on the
# first (eager) call, so that no capture copies it from the host.
_KV_INDEX: dict = {}


def kv_index(sel, device) -> torch.Tensor:
    """The int64 device tensor of kv head list ``sel``
    (:func:`kv_heads`), made once per (heads, device) and kept."""
    key = (tuple(sel), str(device))
    idx = _KV_INDEX.get(key)
    if idx is None:
        idx = _KV_INDEX[key] = torch.tensor(sel, dtype=torch.int64, device=device)
    return idx


def _kv_for(q, k, v, cfg):
    """k and v as the rank's q heads read them: under the qheads scheme
    (q on a slice of the heads, k and v whole) narrowed to, or repeated
    as, the kv heads of its global q heads (:func:`kv_heads`); else as
    they are."""
    if q.shape[2] == cfg.n_heads or k.shape[2] != cfg.n_kv_heads:
        return k, v
    mesh = model_mesh()
    sel = kv_heads(q.shape[2], cfg, mesh)
    k, v = copy_to(k, mesh, MODEL), copy_to(v, mesh, MODEL)
    if isinstance(sel, tuple):
        return k.narrow(2, *sel), v.narrow(2, *sel)
    idx = kv_index(sel, k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def hd_attention(q, k, v, mask, cfg):
    """Attention on this model rank's slice of the head dim (the "hd"
    scheme), plain torch as the reference's: the partial scores QKᵀ over
    the slice, summed over "model" in float32 and scaled by the whole
    head's ``hd ** -0.5``; the softmax over ``mask`` (broadcast to
    (B, H, Sq, Sk); a row with no valid key gives zeros); then the value
    product on the slice, in q's dtype."""
    mesh = model_mesh()
    n_rep = q.shape[2] // k.shape[2]
    kk = L.repeat_kv(k.to(q.dtype), n_rep)
    vv = L.repeat_kv(v.to(q.dtype), n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float())
    s = reduce_from(s, mesh, MODEL) * (cfg.hd ** -0.5)
    s = s.masked_fill(~mask, L.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    probs = (e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)).to(q.dtype)
    # The same probabilities weigh each rank's slice of the values.
    return torch.einsum("bhqk,bkhd->bqhd", copy_to(probs, mesh, MODEL), vv)


def prefill_mask(sq: int, sk: int, *, causal: bool, window: int, prefix_len: int, device):
    """The (Sq, Sk) mask of a prefill from position 0: causal or
    bidirectional, a window, and a bidirectional prefix of ``prefix_len``
    (the prefix-LM mask)."""
    mask = L._position_mask(sq, sk, 0, causal, window, device)
    if prefix_len:
        qpos = torch.arange(sq, device=device)[:, None]
        kpos = torch.arange(sk, device=device)[None, :]
        mask |= (qpos < prefix_len) & (kpos < prefix_len)
    return mask


def attend(q, k, v, cfg, *, causal=True, window=0, prefix_len=0):
    """Prefill and training attention of q (B, Sq, H, hd) over k, v from
    position 0: on a slice of the head dim :func:`hd_attention`; a
    prefix-LM mask (``prefix_len`` > 0) on ``flash_attention``'s prefix
    mode under ``"cuda"``, else ``_prefix_lm_attention``; otherwise
    ``layers.attention``'s dispatch.  Under the qheads scheme k and v are
    first cut to the rank's kv heads (:func:`_kv_for`)."""
    k, v = _kv_for(q, k, v, cfg)
    if q.shape[-1] != cfg.hd:
        mask = prefill_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                            prefix_len=prefix_len, device=q.device)
        return hd_attention(q, k, v, mask, cfg)
    if prefix_len and cfg.kernel_impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.flash_attention(q, k, v, causal=True, window=window, prefix_len=prefix_len)
    if prefix_len:
        return _prefix_lm_attention(q, k, v, prefix_len, window)
    return L.attention(q, k, v, cfg, causal=causal, window=window)


def attend_full(p, x, positions, cfg, *, causal=True, window=0, prefix_len=0):
    """Training (no cache). x: (B, S, d).  The projections are the
    reference's products (``torch.matmul``); attention is :func:`attend`."""
    q, k, v = _project_qkv(p, x, positions, cfg, "reference")
    out = attend(q, k, v, cfg, causal=causal, window=window, prefix_len=prefix_len)
    return _out_proj(out, p["wo"], "reference", cfg)


def _whole(t, n_heads: int, cfg, mesh):
    """q, k or v (B, S, heads, hd) whole over "model": the heads and the
    head dim gathered where the rank holds a slice of them."""
    if t.shape[2] != n_heads:
        t = gather_from(t, mesh, MODEL, 2)
    if t.shape[3] != cfg.hd:
        t = gather_from(t, mesh, MODEL, 3)
    return t


def _to_slice(out, like, mesh):
    """``out`` (B, S, H, hd) cut to the heads and head dim of ``like``, the
    rank's slice of q."""
    for dim in (2, 3):
        n = like.shape[dim]
        if out.shape[dim] != n:
            out = out.narrow(dim, model_offset(n, mesh), n)
    return out


def _refuse_sliced(p, cfg, what: str) -> None:
    if _sliced(p, cfg) is not None:
        raise ValueError(f"{what} is single-rank: the servers take no tensor-parallel mesh")


def _write(cache, slot, k, v, positions, keep=None):
    """In place: the JAX package's .at[bidx, slot].set on a donated cache.
    ``keep`` (B, Sq) bool marks rows that leave their entry as stored: they
    write the entry's current value back, so no host sync decides which
    rows write."""
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    for name, new in (("k", k), ("v", v), ("pos", positions)):
        leaf = cache[name]
        new = new.to(leaf.dtype)
        if keep is not None:
            new = torch.where(keep.view(keep.shape + (1,) * (new.ndim - 2)),
                              leaf[bidx, slot], new)
        leaf.index_put_((bidx, slot), new)


def _prefix_lm_attention(q, k, v, prefix_len: int, window: int):
    """PaliGemma-style: bidirectional over the first ``prefix_len``
    positions, causal elsewhere; causal plus a bidirectional prefix patch,
    as the JAX package computes it (dense, materialized ``repeat_kv``)."""
    b, s, h, hd = q.shape
    kk = L.repeat_kv(k, h // k.shape[2])
    vv = L.repeat_kv(v, h // v.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * (hd ** -0.5)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    pre = (qpos < prefix_len) & (kpos < prefix_len)
    mask = (kpos <= qpos) | pre
    if window:
        mask &= (kpos > qpos - window) | pre
    logits = logits.masked_fill(~mask, L.NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)


def seq_mesh(cfg, mesh=None):
    """``mesh`` (the current one by default) when it shards the contiguous
    caches' timeline over "model" (``cfg.seq_shard_cache`` and a model axis
    of more than one rank), else None."""
    mesh = mesh or current_mesh()
    if cfg.seq_shard_cache and mesh is not None and mesh.shape.get("model", 1) > 1:
        return mesh
    return None


def _write_owned(cache, slot, k, v, positions, mesh):
    """:func:`_write` on a seq-sharded cache: the rows whose slot (in the
    whole timeline) this model rank owns, at their local slot.  The others
    belong to another rank and leave this rank's cache as it was.

    One ``index_put_`` over every row, with no host read and no shape set
    by the data (a CUDA graph records it): an owned row writes its value
    at its local slot; a row another rank owns is sent where its values
    change nothing, as ``index_put_`` with repeated indices keeps one of
    their values: to its batch row's first owned row's slot, carrying
    that row's value, or, where the batch row owns none, to its first
    row's slot (clamped into range), carrying the value stored there."""
    s_loc = cache["k"].shape[1]
    r = mesh.coord["model"]
    owned = torch.div(slot, s_loc, rounding_mode="floor") == r  # (B, Sq)
    local = torch.clamp(slot - r * s_loc, 0, s_loc - 1)
    first = owned.to(torch.int32).argmax(dim=1, keepdim=True)  # (B, 1): 0 where none
    rows = torch.arange(slot.shape[1], device=slot.device).expand_as(slot)
    src = torch.where(owned, rows, first)
    dst = torch.where(owned, local, local.gather(1, first))
    bidx = torch.arange(slot.shape[0], device=slot.device)[:, None]
    some = owned.any(dim=1)[:, None]  # (B, 1)
    for name, new in (("k", k), ("v", v), ("pos", positions)):
        leaf = cache[name]
        val = new[bidx, src].to(leaf.dtype)
        keep = some.view(some.shape + (1,) * (val.ndim - 2))
        leaf.index_put_((bidx, dst), torch.where(keep, val, leaf[bidx, dst]))


def prefill_with_cache(p, x, positions, cfg, cache, *, window=0, prefix_len=0):
    """Prefill that also fills the cache (in place). Assumes S <= cache
    length for a full cache; a rolling cache keeps the trailing window.
    ``prefix_len`` > 0: the prefix-LM mask (the vlm family's image
    patches), on ``flash_attention``'s prefix mode under
    ``kernel_impl="cuda"``.  On a seq-sharded cache (:func:`seq_mesh`) each
    model rank writes the slots it owns, of k and v whole over "model"."""
    q, k, v = _project_qkv(p, x, positions, cfg)
    s = x.shape[1]
    mesh = seq_mesh(cfg)
    cs = cache["k"].shape[1] * (mesh.shape["model"] if mesh else 1)
    k_w, v_w = k, v
    if mesh is not None:
        k_w, v_w = (_whole(t, cfg.n_kv_heads, cfg, mesh) for t in (k, v))
    pos_w = positions
    if window and s > cs:
        # Only the trailing window survives in a rolling cache.
        k_w, v_w, pos_w = k_w[:, -cs:], v_w[:, -cs:], positions[:, -cs:]
    slot = (pos_w % cs if window else pos_w).long()
    if mesh is not None:
        _write_owned(cache, slot, k_w, v_w, pos_w, mesh)
    else:
        _write(cache, slot, k_w, v_w, pos_w)
    out = attend(q, k, v, cfg, causal=True, window=window, prefix_len=prefix_len)
    return _out_proj(out, p["wo"], cfg.kernel_impl, cfg), cache


def pos_vector(pos, b: int, device=None):
    """Normalize a decode position to a per-slot int32 vector: a scalar
    (uniform batch) broadcasts to (B,); a (B,) vector (continuous batch)
    passes through.  A Python int becomes a device fill, not a host copy,
    so a decode loop never waits on the card."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((b,), int(pos), dtype=torch.int32, device=device)
    p = pos.to(device=device or pos.device, dtype=torch.int32)
    if p.ndim == 0:
        return p.expand(b).contiguous()
    if tuple(p.shape) != (b,):
        raise ValueError(f"pos must be scalar or shape ({b},), got {tuple(p.shape)}")
    return p


def decode_step(p, x, pos, cfg, cache, *, window=0):
    """Decode step. x: (B, Sq, d); pos: a scalar absolute position or a (B,)
    vector of per-slot positions.  Sq > 1 is the multi-row step: the Sq
    tokens of a slot sit at consecutive positions ``pos .. pos+Sq-1``; all
    Sq keys are written into the cache *before* attention, and each query
    row masks at its own depth.  A paged cache (a ``"table"`` leaf) is
    written through its block table instead of per-slot rows.  A contiguous
    cache may carry a ``"keep"`` leaf, (B, Sq) bool per layer: those rows
    leave their entries as stored (the speculative draft's first step,
    ``serve/step.py``)."""
    b, sq = x.shape[0], x.shape[1]
    posv = pos_vector(pos, b, x.device)
    positions = posv[:, None] + torch.arange(sq, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, positions, cfg)
    q_rank = q
    mesh = seq_mesh(cfg)
    if mesh is not None:
        if sq != 1 or "table" in cache:
            raise ValueError("the seq-sharded mesh decode is single-row and contiguous")
        q = _whole(q, cfg.n_heads, cfg, mesh)
        k, v = (_whole(t, cfg.n_kv_heads, cfg, mesh) for t in (k, v))
        cs = cache["k"].shape[1] * mesh.shape["model"]
        slot = (positions % cs if window else positions).long()
        _write_owned(cache, slot, k, v, positions, mesh)
    elif "table" in cache:
        _refuse_sliced(p, cfg, "the paged cache")
        _paged_write(cache, k, v, positions, window)
    else:
        cs = cache["k"].shape[1]
        slot = positions % cs if window else positions  # (B, Sq)
        _write(cache, slot.long(), k, v, positions, cache.get("keep"))
    out = cached_attention(q, cache, posv, cfg, window=window)
    if mesh is not None:
        out = _to_slice(out, q_rank, mesh)
    return _out_proj(out, p["wo"], cfg.kernel_impl, cfg), cache


def chunk_step(p, x, posv, valid, cfg, cache, *, window=0):
    """Mixed-phase prefill chunk: Sq prompt tokens per slot at consecutive
    positions ``posv .. posv+Sq-1``, row-masked by ``valid`` (B, Sq).
    Invalid rows (past the slot's prompt end, or rows of slots already
    decoding, whose cursor sits at the prompt length) neither write the
    cache nor leave attendable keys; their outputs are garbage and callers
    must not consume them.  Valid rows scatter-then-attend like
    :func:`decode_step`, so each attends precisely the keys the
    whole-prompt prefill row at the same position would: that carries the
    bit-identity contract across the chunk/whole seam.  The cache is
    written in place."""
    _refuse_sliced(p, cfg, "chunked prefill")
    b, sq = x.shape[0], x.shape[1]
    posv = pos_vector(posv, b, x.device)
    positions = posv[:, None] + torch.arange(sq, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, positions, cfg)
    if "table" in cache:
        _paged_chunk_write(cache, k, v, positions, valid)
    else:
        _chunk_write(cache, k, v, positions, valid)
    out = chunk_attention(q, cache, posv, cfg, window=window)
    return _out_proj(out, p["wo"], cfg.kernel_impl, cfg), cache


def _chunk_write(cache, kt, vt, positions, valid):
    """Masked contiguous scatter of chunk rows, in place, with no host sync.
    The JAX package scatters invalid rows out of bounds and drops them;
    ``index_put_`` rejects such indices, and an invalid row's own position
    may be a live entry (a decoding slot's rows sit at its decode
    positions).  So every invalid row is sent to one *anchor* entry of its
    slot and writes there the value that entry receives anyway: the first
    valid row's new value, or, in a slot with no valid row, the entry's
    current value.  Every index then receives one value, whatever order
    the scatter runs in."""
    b, sq = positions.shape
    cs = cache["k"].shape[1]
    ar = torch.arange(b, device=positions.device)
    first = valid.to(torch.int32).argmax(dim=1)  # the first valid row (0: none)
    some = valid.any(dim=1)
    anchor = torch.where(some, positions[ar, first], torch.clamp(positions[:, 0], max=cs - 1))
    slot = torch.where(valid, positions, anchor[:, None]).long()
    for name, new in (("k", kt), ("v", vt), ("pos", positions)):
        leaf = cache[name]
        new = new.to(leaf.dtype)
        tail = (1,) * (new.ndim - 2)
        keep = torch.where(some.view(b, *tail), new[ar, first], leaf[ar, anchor.long()])
        vals = torch.where(valid.view(b, sq, *tail), new, keep[:, None])
        leaf.index_put_((ar[:, None], slot), vals)


def _paged_chunk_write(cache, kt, vt, positions, valid):
    """Masked paged scatter for chunk rows, in place: invalid rows are
    redirected to the pool's sink block (block 0, never addressed by a
    live table) instead of writing through the slot's table.  The tile
    clamp only guards the table gather; masking happens on the resolved
    physical block, so a slot's real table entries are never doctored."""
    bl = cache["k"].shape[1]
    nmax = cache["table"].shape[1]
    blk = torch.clamp(positions // bl, max=nmax - 1).long()
    off = (positions % bl).long()
    bidx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    phys = torch.where(valid, cache["table"][bidx, blk], 0).long()
    cache["k"].index_put_((phys, off), kt.to(cache["k"].dtype))
    cache["v"].index_put_((phys, off), vt.to(cache["v"].dtype))
    cache["pos"].index_put_((phys, off), positions.to(cache["pos"].dtype))
    return cache


def chunk_attention(q, cache, posv, cfg, *, window=0):
    """Attention of chunk rows over the cache as stored: row j of slot b
    attends recorded positions ``<= posv[b]+j``.

    Under ``cfg.kernel_impl == "cuda"`` the rows go to ``flash_decode``'s
    chunk launch (``kernels.flash_decode.flash_decode_chunk``), which walks
    the prefill kernel's tile partition (``flash_attention``'s block_k),
    not ``cfg.decode_block``: the one-shot reference for a chunk row is a
    ``flash_attention`` prefill row, and equal partitions (plus the exact
    zeros of the masked tail) make the two bitwise equal.  A paged cache is
    gathered to the logical contiguous layout first for the same reason:
    ``flash_decode_paged`` tiles at the block length.  Otherwise the dense
    reference :func:`_chunk_dense`."""
    from repro_torch.kernels.flash_decode import gather_pool

    posv = pos_vector(posv, q.shape[0], q.device)
    if "table" in cache:
        tbl = cache["table"]
        k, v, kpos = (gather_pool(cache[n], tbl) for n in ("k", "v", "pos"))
    else:
        k, v, kpos = cache["k"], cache["v"], cache["pos"]
    if cfg.kernel_impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.flash_decode_chunk(q, k, v, kpos, posv, window=window)
    return _chunk_dense(q, k, v, kpos, posv, window=window)


def _chunk_dense(q, k, v, kpos, posv, *, window=0):
    """Dense chunk attention: ``layers.naive_attention``'s term order (the
    whole-prompt prefill reference: materialized ``repeat_kv``, full
    softmax) with the positional causal mask replaced by the recorded-
    position mask.  On the cache invariant that logical index i only ever
    holds kpos ∈ {i, −1}, the two masks select the same keys and the masked
    tail adds exact zeros, so chunk rows equal prefill rows bitwise.  Not
    :func:`_ragged_dense`: the reference here is the prefill path, not the
    decode path."""
    b, sq, h, hd = q.shape
    n_rep = h // k.shape[2]
    kk = L.repeat_kv(k.to(q.dtype), n_rep)
    vv = L.repeat_kv(v.to(q.dtype), n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * (hd ** -0.5)
    rowpos = posv[:, None] + torch.arange(sq, dtype=torch.int32, device=q.device)
    mask = ragged_valid_mask(kpos[:, None, :], rowpos[:, :, None], window)
    logits = logits.masked_fill(~mask[:, None], L.NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)


def _paged_write(cache, kt, vt, positions, window):
    """Scatter Sq tokens' K/V/pos through the block table, in place.
    kt/vt: (B, Sq, KV, hd); positions: (B, Sq).  Logical index = ``pos``
    (full cache) or ``pos % ring`` (rolling: the logical capacity
    ``nmax*bl`` equals the contiguous ring size by construction, so the ring
    layout is preserved).  The tile index is clamped so slots whose position
    ran past their table (exited slots decoding garbage on static shapes)
    write into their table's sink entry instead of indexing out of
    bounds."""
    bl = cache["k"].shape[1]
    nmax = cache["table"].shape[1]
    li = positions % (nmax * bl) if window else positions
    blk = torch.clamp(li // bl, max=nmax - 1).long()
    off = (li % bl).long()
    bidx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    phys = cache["table"][bidx, blk].long()  # (B, Sq)
    cache["k"].index_put_((phys, off), kt.to(cache["k"].dtype))
    cache["v"].index_put_((phys, off), vt.to(cache["v"].dtype))
    cache["pos"].index_put_((phys, off), positions.to(cache["pos"].dtype))
    return cache


def ragged_valid_mask(kpos, pos, window: int):
    """THE ragged-decode validity predicate, shared by every decode path
    (the dense fallback, the kernel's plain version and ``needed_tiles``;
    the CUDA kernel computes the same expression): a recorded position is
    attendable iff ``0 <= kpos <= pos`` and, for rolling caches, within the
    window.  ``kpos``/``pos`` broadcast elementwise."""
    valid = (kpos >= 0) & (kpos <= pos)
    if window > 0:
        valid &= kpos > pos - window
    return valid


def _ragged_dense(q, k, v, kpos, posv, *, window=0):
    """Dense ragged-decode attention: Sq queries per slot over the cache as
    stored, masked by recorded positions, GQA via a grouped-head einsum.
    Row j of slot b sits at ``posv[b] + j``.  A slot with no valid keys
    returns zeros."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                          k.to(q.dtype).float()) * (hd ** -0.5)
    rowpos = posv[:, None] + torch.arange(sq, dtype=torch.int32, device=q.device)
    vm = ragged_valid_mask(kpos[:, None, :], rowpos[:, :, None],
                           window)[:, None, None, :, :]
    logits = torch.where(vm, logits, L.NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    # Mask p explicitly (not via exp underflow): an all-empty slot has
    # m == -1e30 and exp(0) == 1 everywhere, which must not count.
    p = torch.where(vm, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    probs = (p / torch.clamp(l, min=1e-30)).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.to(q.dtype))
    return out.reshape(b, sq, h, hd)


def flash_decode_attention(q, cache, pos, cfg, *, window=0, mesh=None):
    """Sequence-sharded decode attention (the reference's shard_map over
    "model"): q (B, 1, H, hd) on every model rank, the rank's slice of the
    cache timeline (B, S/par, KV, hd).  Each rank computes the masked
    partial softmax over its slice, as the reference's ``local_fn`` in
    plain torch (float32 scores, grouped GQA heads, p rounded to q's dtype
    for the value product, which accumulates in float32 as the port's
    ``flash_decode`` kernel does; the reference's einsum rounds it to q's
    dtype as well), and the partials merge by the online-softmax identity:

        m_g = max(m);  l_g = sum(l e^{m - m_g});  acc_g = sum(acc e^{m - m_g})

    three ``all_reduce``s over "model" (MAX, SUM, SUM) a layer.  A slot
    with no valid key returns zeros."""
    mesh = mesh or current_mesh()
    b, sq, h, hd = q.shape
    if sq != 1:
        raise ValueError("the seq-sharded mesh decode is single-row")
    kvh = cache["k"].shape[2]
    posv = pos_vector(pos, b, q.device)
    qg = q[:, 0].reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(),
                     cache["k"].to(q.dtype).float()) * (cfg.hd ** -0.5)
    vm = ragged_valid_mask(cache["pos"], posv[:, None], window)[:, None, None, :]
    s = torch.where(vm, s, L.NEG_INF)
    m = s.amax(dim=-1)  # (B, KV, n_rep)
    p = torch.where(vm, torch.exp(s - m[..., None]), 0.0)
    l_loc = p.sum(dim=-1)
    acc = torch.einsum("bgrk,bkgd->bgrd", p.to(q.dtype).float(),
                       cache["v"].to(q.dtype).float())
    m_g = mesh.all_reduce(m.clone(), ("model",), "max")
    corr = torch.exp(m - m_g)
    l_g = mesh.all_reduce(l_loc * corr, ("model",))
    acc_g = mesh.all_reduce(acc * corr[..., None], ("model",))
    out = acc_g / torch.clamp(l_g[..., None], min=1e-30)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _paged_dense(q, cache, posv, *, window=0):
    """Dense paged-decode attention: gather the slot's physical blocks into
    the logical (B, nmax·bl, KV, hd) layout through the block table, then
    run the same dense ragged attention as the contiguous path.  The gather
    is an exact permutation, and unreserved table entries resolve to the
    pool's never-written null block (kpos = −1, exactly masked), so paged
    outputs equal contiguous outputs on the same recorded timeline."""
    from repro_torch.kernels.flash_decode import gather_pool

    tbl = cache["table"]
    return _ragged_dense(q, gather_pool(cache["k"], tbl), gather_pool(cache["v"], tbl),
                         gather_pool(cache["pos"], tbl), posv, window=window)


def cached_attention(q, cache, pos, cfg, *, window=0):
    """Attention of Sq query rows per slot over the cache, masked by
    recorded slot positions.  A paged cache (a ``"table"`` leaf) goes to the
    ``flash_decode_paged`` kernel under ``cfg.kernel_impl == "cuda"`` (its
    tile is the pool's block length) or to the gather-then-dense reference;
    a contiguous cache to the ``flash_decode`` kernel or the dense
    grouped-GQA reference, or, seq-sharded over a mesh (:func:`seq_mesh`),
    to :func:`flash_decode_attention`.  The kernels run their plain
    versions on CPU tensors.  A rank's slice of the heads reads the kv
    heads of its q heads (:func:`_kv_for`); a slice of the head dim takes
    :func:`hd_attention` over the recorded positions."""
    posv = pos_vector(pos, q.shape[0], q.device)
    if "table" not in cache and seq_mesh(cfg) is not None:
        return flash_decode_attention(q, cache, posv, cfg, window=window)
    if "table" not in cache and (q.shape[2] != cfg.n_heads or q.shape[3] != cfg.hd):
        k, v = _kv_for(q, cache["k"], cache["v"], cfg)
        if q.shape[3] != cfg.hd:
            rowpos = posv[:, None] + torch.arange(q.shape[1], dtype=torch.int32,
                                                  device=q.device)
            mask = ragged_valid_mask(cache["pos"][:, None, :], rowpos[:, :, None], window)
            return hd_attention(q, k, v, mask[:, None], cfg)
        cache = {"k": k.contiguous(), "v": v.contiguous(), "pos": cache["pos"]}
    if "table" in cache:
        if cfg.kernel_impl == "cuda":
            from repro_torch.kernels import ops as kops

            return kops.flash_decode_paged(q, cache["k"], cache["v"], cache["pos"],
                                           cache["table"], posv, window=window)
        return _paged_dense(q, cache, posv, window=window)
    if cfg.kernel_impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.flash_decode(q, cache["k"], cache["v"], cache["pos"], posv,
                                 window=window, block_k=cfg.decode_block or 128)
    return _ragged_dense(q, cache["k"], cache["v"], cache["pos"], posv,
                         window=window)
