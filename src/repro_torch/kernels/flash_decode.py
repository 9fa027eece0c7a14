"""Ragged flash-decode: batched decode attention over the KV cache as stored.

Port of the JAX package's Pallas TPU kernel ``kernels/flash_decode.py``
(``flash_decode``).  One query token per slot (or Sq consecutive rows)
against ``(B, S, KV, hd)`` k/v in any storage dtype, the recorded-position
vector ``kpos`` (−1 = empty) and per-slot positions ``pos``:

- **GQA folded into rows.**  q is read as ``(B, KV, Sq·n_rep, hd)``: each
  K/V tile serves its whole query-head group.
- **Position masking.**  Row j of slot b attends ``0 <= kpos <= pos[b]+j``
  (and ``kpos > pos[b]+j-window`` for rolling caches).
- **Per-slot tile skip.**  ``needed_tiles`` (on the device, no host sync)
  counts the KV tiles a slot needs and the kernel loops over that many; the
  tensor-core body counts them the same way inside the kernel.

A row with no valid keys returns exact zeros.  A slot's reduction order is
its own, whatever batch it shares the call with.

``flash_decode`` launches the CUDA kernel (``csrc/flash_decode.cu``) on CUDA
tensors and runs ``flash_decode_plain``, the same tiles and masks as a
loop in PyTorch, on CPU tensors.  On the card, bfloat16 queries at hd
64/112/128/256 run the tensor-core body with a split over the keys: each slot's
needed tiles are cut into chunks of ``chunk_tiles(block_k)`` tiles (256
keys), one block per (kv head, slot, chunk), and a second small kernel
merges a slot's chunk partials in ascending order.  The chunk size depends
on ``block_k`` alone, so the split keeps every slot's result bitwise
independent of the batch; ``flash_decode_paged`` at ``block_k = bl`` takes
the same chunks.  :func:`launch_plan` and :func:`paged_launch_plan` give
the body, chunk plan and shared memory of a launch.

The tensor-core body's key parts come from one query token's ``n_rep``
rows (``_build.mma_plan(n_rep, bk, hd)``), never from Sq: a multi-row
launch (speculative verify, Sq = k + 1) whose rows outgrow one block's
``MMA_ROWS // ks`` rows takes more row blocks, each summing its rows' keys
in the one-row order, so row j of a verify is bitwise the one-row launch at
``pos + j`` (tiles and key chunks past a row's position add exact zeros).

``flash_decode_chunk`` is the same kernel's chunk launch, for chunked
prefill's rows (the JAX package calls ``flash_decode`` at its prefill tile
size there, ``models/attention.py:chunk_attention``): any Sq, a grid over
64-row groups of a kv head's rows, ``flash_attention``'s tiles walked from
tile 0 in one pass (no key chunks) with a 64-row prefill block's key
parts, so its rows are bitwise the prefill kernel's rows at the same
positions.  :func:`chunk_launch_plan` gives its plan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import BLOCK_K as PREFILL_BLOCK_K
from repro_torch.models.attention import ragged_valid_mask


NEG_INF = -1e30
CHUNK_BLOCK_Q = 64  # query positions of one block of the chunk launch's FMA route


def needed_tiles(kpos, pos, *, window: int = 0, block_k: int = 128, sq: int = 1):
    """Per-slot KV tile count the ragged kernel touches.

    ``kpos``: (B, S) recorded positions (−1 = empty); ``pos``: (B,) query
    positions.  Returns (B,) int32 in [1, ceil(S/block_k)]: 1 + the last
    tile holding any key with ``0 <= kpos <= pos + sq - 1`` (window-masked
    from the shallowest row when ``window > 0``); an all-empty slot counts 1.
    Stays on kpos's device: no host sync."""
    s = kpos.shape[1]
    valid = ragged_valid_mask(kpos, pos[:, None] + (sq - 1), 0)
    if window > 0:
        valid &= kpos > pos[:, None] - window
    tile = (torch.arange(s, dtype=torch.int32, device=kpos.device) // block_k)[None, :]
    last = torch.where(valid, tile, -1).amax(dim=1)
    return torch.clamp(last + 1, min=1).to(torch.int32)


def _pad_cache(k, v, kpos, bk):
    pad = (-k.shape[1]) % bk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        # Padding is recorded-position -1 == empty == masked out.
        kpos = F.pad(kpos, (0, pad), value=-1)
    return k, v, kpos


def flash_decode_plain(q, k, v, kpos, pos, *, window: int = 0, block_k: int = 128):
    """The kernel's function in PyTorch: a loop over KV tiles up to the
    batch's deepest needed tile, the same masks and online softmax in
    float32, p rounded to the value dtype before PV.  Sq > 1 rows run one
    query token at a time, row j as the one-row call at ``pos + j`` (the
    kernel's contract: a verify row is bitwise its one-row launch).  The
    CPU path, and the kernel's oracle on the card."""
    b, sq, h, hd = q.shape
    if sq > 1:
        return torch.cat([flash_decode_plain(q[:, j:j + 1], k, v, kpos, pos + j,
                                             window=window, block_k=block_k)
                          for j in range(sq)], dim=1)
    kvh = k.shape[2]
    n_rep = h // kvh
    rows = sq * n_rep
    bk = min(block_k, k.shape[1])
    k, v, kpos = _pad_cache(k, v, kpos, bk)
    pos = pos.to(torch.int32)
    n_hi = int(needed_tiles(kpos, pos, window=window, block_k=bk, sq=sq).max())
    qg = (q.reshape(b, sq, kvh, n_rep, hd).permute(0, 2, 1, 3, 4)
          .reshape(b, kvh, rows, hd).float())
    rowpos = pos[:, None] + torch.arange(rows, dtype=torch.int32, device=q.device) // n_rep
    scale = hd ** -0.5
    m = torch.full((b, kvh, rows), NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, rows), device=q.device)
    acc = torch.zeros((b, kvh, rows, hd), device=q.device)
    for i in range(n_hi):
        kb = k[:, i * bk:(i + 1) * bk].to(q.dtype).float()
        vb = v[:, i * bk:(i + 1) * bk].to(q.dtype)
        kp = kpos[:, i * bk:(i + 1) * bk]
        s = torch.einsum("bgrd,bkgd->bgrk", qg, kb) * scale
        valid = ragged_valid_mask(kp[:, None, :], rowpos[:, :, None], window)[:, None]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # Mask p explicitly: an all-masked tile has m_new == NEG_INF and
        # exp(s - m_new) == 1, which must not count.
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrk,bkgd->bgrd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return (out.reshape(b, kvh, sq, n_rep, hd).permute(0, 2, 1, 3, 4)
            .reshape(b, sq, h, hd).to(q.dtype))


def _plan(b, n_tiles, bk, sq, h, kv, hd, q_dtype, kv_dtype) -> dict:
    req = _build.require
    req(min(b, sq, h, kv, hd) > 0, "empty shape")
    req(h % kv == 0, f"H={h} is not a multiple of KV={kv}")
    for dt in (q_dtype, kv_dtype):
        req(dt in _build.DTYPE_CODES, f"kernel takes float32 or bfloat16, got {dt}")
    req(hd * (4 if kv_dtype == torch.float32 else 2) % 16 == 0,
        f"hd={hd}: k/v rows must be whole 16-byte vectors (the kernel's loads)")
    n_rep = h // kv
    rows = sq * n_rep
    req(rows <= _build.MAX_ROWS, f"Sq*n_rep={rows} > {_build.MAX_ROWS} rows")
    req(0 < bk <= _build.MAX_BLOCK_K, f"block_k={bk} outside 1..{_build.MAX_BLOCK_K}")
    req(b <= 65535, f"B={b} > 65535 blocks")
    if _build.uses_mma(q_dtype, n_rep, bk, hd):
        chunks = _build.key_chunks(n_tiles, bk)
        # The key parts of one query token's n_rep rows, never of Sq: a
        # verify row sums in the order of its one-row launch.
        ks, sb, _ = _build.mma_plan(n_rep, bk, hd)
        block_rows = _build.MMA_ROWS // ks
        row_blocks = -(-rows // block_rows)
        plan = dict(route="mma", chunk_tiles=_build.chunk_tiles(bk), chunks=chunks,
                    grid=(kv * row_blocks, b, chunks), key_parts=ks, stage_keys=sb,
                    block_rows=block_rows, row_blocks=row_blocks,
                    smem=_build.mma_smem_bytes(n_rep, bk, hd),
                    scratch_floats=b * kv * (chunks * rows * (hd + 2) + 1) if chunks > 1
                    else 0)
    else:
        plan = dict(route="fma", chunk_tiles=n_tiles, chunks=1, grid=(kv, b),
                    smem=_build.smem_bytes(rows, hd, bk), scratch_floats=0)
    req(plan["smem"] <= _build.MAX_SMEM, f"hd={hd} too wide: {plan['smem']} bytes of "
        f"shared memory")
    return dict(plan, rows=rows, block_k=bk, tiles=n_tiles)


def launch_plan(b: int, s: int, sq: int, h: int, kv: int, hd: int, q_dtype, kv_dtype, *,
                block_k: int = 128) -> dict:
    """Shape admission of the ``flash_decode`` kernel, as
    ``flash_decode_launch`` checks it: the body (``"mma"`` or ``"fma"``),
    the tile size ``min(block_k, S)``, the key-chunk plan (``chunk_tiles``
    per chunk, ``chunks`` on the grid's third axis, from S on the host), the
    grid, the dynamic shared memory and the float32 scratch of the chunk
    partials.  Raises ValueError on a shape the kernel cannot take.  Pure:
    the CPU tests call it."""
    bk = min(block_k, s)
    return _plan(b, -(-s // bk), bk, sq, h, kv, hd, q_dtype, kv_dtype)


def paged_launch_plan(b: int, nmax: int, bl: int, sq: int, h: int, kv: int, hd: int,
                      q_dtype, kv_dtype) -> dict:
    """:func:`launch_plan` of ``flash_decode_paged``: ``nmax`` tiles of
    ``bl`` keys, the plan of ``flash_decode`` at ``block_k = bl`` on the
    gathered (B, nmax·bl) layout."""
    return _plan(b, nmax, bl, sq, h, kv, hd, q_dtype, kv_dtype)


def flash_decode(q, k, v, kpos, pos, *, window: int = 0, block_k: int = 128):
    """q: (B,Sq,H,hd); k/v: (B,S,KV,hd) with H % KV == 0 (float32 or
    bfloat16 storage, cast to q's dtype in the load); kpos: (B,S) int32;
    pos: (B,) int32.  Returns (B,Sq,H,hd) in q.dtype.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`flash_decode_plain`."""
    _build.refuse_grad("flash_decode", q, k, v)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kpos, pos, window=window, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu tensors, got {q.device}")
    return _flash_decode_cuda(q, k, v, kpos, pos, window=window, block_k=block_k)


def _flash_decode_cuda(q, k, v, kpos, pos, *, window, block_k):
    import ctypes

    b, sq, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    req = _build.require
    req(all(t.device == q.device for t in (k, v, kpos, pos)), "all tensors on one device")
    req(k.shape == v.shape and k.shape[0] == b and k.shape[3] == hd,
        f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    req(tuple(kpos.shape) == (b, s) and tuple(pos.shape) == (b,), "kpos (B,S), pos (B,)")
    req(k.dtype == v.dtype, "k and v share one storage dtype")
    plan = launch_plan(b, s, sq, h, kvh, hd, q.dtype, k.dtype, block_k=block_k)
    loaded = (q, k, v) if plan["route"] == "mma" else (k, v)  # by 16-byte copies
    req(all(t.data_ptr() % 16 == 0 for t in loaded),
        "q (tensor-core body) and k/v must be 16-byte aligned (the kernel's loads)")
    req(kpos.dtype == torch.int32 and pos.dtype == torch.int32, "kpos/pos are int32")
    req(all(t.is_contiguous() for t in (q, k, v, kpos, pos)), "contiguous tensors")
    bk = plan["block_k"]
    # The tensor-core route counts each slot's tiles on the device itself.
    nt = (needed_tiles(kpos, pos, window=window, block_k=bk, sq=sq)
          if plan["route"] == "fma" else None)
    out = torch.empty_like(q)
    scratch = (torch.empty(plan["scratch_floats"], dtype=torch.float32, device=q.device)
               if plan["scratch_floats"] else None)
    fn = _build.kernel_fn("flash_decode", "flash_decode_launch",
                          [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float]
                          + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
                 pos.data_ptr(), nt.data_ptr() if nt is not None else None, out.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 b, s, sq, h, kvh, hd, bk, window, hd ** -0.5, _build.dtype_code(q),
                 _build.dtype_code(k), plan["chunks"], torch.cuda.current_stream().cuda_stream)
    _build.check("flash_decode", err)
    _build.count("flash_decode", multi_row=sq > 1)
    return out


# --------------------------------------------------- chunked prefill rows


def flash_decode_chunk_plain(q, k, v, kpos, pos, *, window: int = 0,
                             block_k: int = PREFILL_BLOCK_K):
    """The chunk launch's function in PyTorch: ``flash_attention_plain``'s
    walk (query rows in blocks of 64 positions, KV tiles of ``block_k``
    keys from tile 0 in one pass, the same float32 online softmax) with its
    positional causal mask replaced by the recorded-position mask: row j of
    slot b attends ``0 <= kpos <= pos[b] + j``.  Tiles past a row's needed
    ones are fully masked and leave its sums unchanged, so a row equals
    ``flash_attention_plain``'s row at the same position when the cache
    holds that prompt's keys.  The CPU path, and the launch's oracle on the
    card."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    n_rep = h // kvh
    bk = block_k
    pos = pos.to(torch.int32)
    n_hi = int(needed_tiles(kpos, pos, window=window, block_k=bk, sq=sq).max())
    scale = hd ** -0.5
    out = torch.empty_like(q)
    for q0 in range(0, sq, CHUNK_BLOCK_Q):
        rows = min(CHUNK_BLOCK_Q, sq - q0)
        qg = q[:, q0:q0 + rows].reshape(b, rows, kvh, n_rep, hd).float()
        rowpos = pos[:, None] + q0 + torch.arange(rows, dtype=torch.int32, device=q.device)
        m = torch.full((b, h, rows), NEG_INF, device=q.device)
        l = torch.zeros((b, h, rows), device=q.device)
        acc = torch.zeros((b, h, rows, hd), device=q.device)
        for t in range(n_hi):
            kb = k[:, t * bk:(t + 1) * bk].to(q.dtype)
            vb = v[:, t * bk:(t + 1) * bk].to(q.dtype)
            kc = kb.shape[1]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb.float()).reshape(b, h, rows, kc)
            s = s * scale
            valid = ragged_valid_mask(kpos[:, None, t * bk:(t + 1) * bk],
                                      rowpos[:, :, None], window)[:, None]
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pg = p.to(vb.dtype).float().reshape(b, kvh, n_rep, rows, kc)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", pg, vb.float())
            acc = acc * alpha[..., None] + pv.reshape(b, h, rows, hd)
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + rows] = o.transpose(1, 2).to(q.dtype)
    return out


def chunk_launch_plan(b: int, s: int, sq: int, h: int, kv: int, hd: int, q_dtype, kv_dtype,
                      *, block_k: int = PREFILL_BLOCK_K) -> dict:
    """Shape admission of the chunk launch (``flash_decode_chunk_launch``):
    the prefill kernel's plan on a ragged cache.  Tiles of ``block_k``
    keys (not cut to S), walked in one pass from tile 0 (no key chunks, no
    combine kernel); on the tensor-core body the key parts ``ks`` and stage
    width of a 64-row prefill block whatever the chunk length, and a grid
    over (kv head, slot, 64-row group of the slot's Sq·n_rep rows); on the
    FMA body a grid over (64-position tile, slot x head), as
    ``flash_attention``'s.  Any Sq.  Raises ValueError on a shape the
    kernel cannot take.  Pure: the CPU tests call it."""
    req = _build.require
    req(min(b, s, sq, h, kv, hd) > 0, "empty shape")
    req(h % kv == 0, f"H={h} is not a multiple of KV={kv}")
    for dt in (q_dtype, kv_dtype):
        req(dt in _build.DTYPE_CODES, f"kernel takes float32 or bfloat16, got {dt}")
    req(hd * (4 if kv_dtype == torch.float32 else 2) % 16 == 0,
        f"hd={hd}: k/v rows must be whole 16-byte vectors (the kernel's loads)")
    bk = block_k
    req(0 < bk <= _build.MAX_BLOCK_K, f"block_k={bk} outside 1..{_build.MAX_BLOCK_K}")
    rows = sq * (h // kv)
    n_tiles = -(-s // bk)
    if _build.uses_mma(q_dtype, _build.MMA_ROWS, bk, hd):
        ks, sb, _ = _build.mma_plan(_build.MMA_ROWS, bk, hd)
        plan = dict(route="mma", row_groups=-(-rows // _build.MMA_ROWS),
                    grid=(kv, b, -(-rows // _build.MMA_ROWS)), key_parts=ks, stage_keys=sb,
                    smem=_build.mma_smem_bytes(_build.MMA_ROWS, bk, hd))
        req(b <= 65535 and plan["grid"][2] <= 65535, f"grid {plan['grid']} too large")
    else:
        bq = min(CHUNK_BLOCK_Q, sq)
        plan = dict(route="fma", row_groups=-(-sq // bq), grid=(-(-sq // bq), b * h),
                    smem=_build.smem_bytes(bq, hd, bk))
        req(b * h <= 65535, f"{b * h} blocks on the grid's second axis > 65535")
    req(plan["smem"] <= _build.MAX_SMEM, f"hd={hd} too wide: {plan['smem']} bytes of "
        f"shared memory")
    return dict(plan, rows=rows, block_k=bk, tiles=n_tiles, chunks=1)


def flash_decode_chunk(q, k, v, kpos, pos, *, window: int = 0,
                       block_k: int = PREFILL_BLOCK_K):
    """Chunked prefill's rows: the multi-row mode of ``flash_decode`` at the
    prefill kernel's partition.  q: (B,Sq,H,hd), any Sq, row j of slot b at
    position ``pos[b] + j``; k/v: (B,S,KV,hd) the cache as stored (float32
    or bfloat16, cast to q's dtype in the load); kpos: (B,S) int32 (−1 =
    empty); pos: (B,) int32.  Returns (B,Sq,H,hd) in q.dtype.

    Unlike :func:`flash_decode` the launch walks ``flash_attention``'s
    tiles (``block_k`` 64) in one pass with a 64-row block's key parts, so
    on the cache invariant that logical index i holds kpos ∈ {i, −1} a row
    selects the same keys in the same stage order as the prefill row at
    that position.  Counted under ``flash_decode`` in the launch counts.

    CUDA tensors launch the kernel (``flash_decode_chunk_launch`` in
    ``csrc/flash_decode.cu``) or raise; CPU tensors take
    :func:`flash_decode_chunk_plain`."""
    _build.refuse_grad("flash_decode", q, k, v)
    if q.device.type == "cpu":
        return flash_decode_chunk_plain(q, k, v, kpos, pos, window=window, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_chunk runs on cuda or cpu tensors, got {q.device}")
    return _flash_decode_chunk_cuda(q, k, v, kpos, pos, window=window, block_k=block_k)


def _flash_decode_chunk_cuda(q, k, v, kpos, pos, *, window, block_k):
    import ctypes

    b, sq, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    req = _build.require
    req(all(t.device == q.device for t in (k, v, kpos, pos)), "all tensors on one device")
    req(k.shape == v.shape and k.shape[0] == b and k.shape[3] == hd,
        f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    req(tuple(kpos.shape) == (b, s) and tuple(pos.shape) == (b,), "kpos (B,S), pos (B,)")
    req(k.dtype == v.dtype, "k and v share one storage dtype")
    plan = chunk_launch_plan(b, s, sq, h, kvh, hd, q.dtype, k.dtype, block_k=block_k)
    loaded = (q, k, v) if plan["route"] == "mma" else (k, v)  # by 16-byte copies
    req(all(t.data_ptr() % 16 == 0 for t in loaded),
        "q (tensor-core body) and k/v must be 16-byte aligned (the kernel's loads)")
    req(kpos.dtype == torch.int32 and pos.dtype == torch.int32, "kpos/pos are int32")
    req(all(t.is_contiguous() for t in (q, k, v, kpos, pos)), "contiguous tensors")
    bk = plan["block_k"]
    # The tensor-core route counts each block's tiles on the device itself.
    nt = (needed_tiles(kpos, pos, window=window, block_k=bk, sq=sq)
          if plan["route"] == "fma" else None)
    out = torch.empty_like(q)
    fn = _build.kernel_fn("flash_decode", "flash_decode_chunk_launch",
                          [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float]
                          + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with _build.on_device(q.device) as stream:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(), pos.data_ptr(),
                 nt.data_ptr() if nt is not None else None, out.data_ptr(), b, s, sq, h, kvh,
                 hd, bk, window, hd ** -0.5, _build.dtype_code(q), _build.dtype_code(k),
                 stream)
    _build.check("flash_decode", err)
    _build.count("flash_decode")
    return out


# ------------------------------------------------------------- paged pool


def gather_pool(pool, tables):
    """The logical contiguous layout of a block pool: ``pool`` (N, bl, ...)
    gathered through ``tables`` (B, nmax) into (B, nmax·bl, ...).  Logical
    tile i of slot b is physical block ``tables[b, i]``."""
    b, nmax = tables.shape
    g = pool[tables.long()]
    return g.reshape((b, nmax * pool.shape[1]) + tuple(pool.shape[2:]))


def flash_decode_paged_plain(q, k, v, kpos, tables, pos, *, window: int = 0):
    """The paged kernel's function in PyTorch: gather the slot's blocks into
    the logical layout and run :func:`flash_decode_plain` at ``block_k =
    bl``, the tile the kernel walks.  The CPU path, and the kernel's oracle
    on the card."""
    return flash_decode_plain(q, gather_pool(k, tables), gather_pool(v, tables),
                              gather_pool(kpos, tables), pos, window=window,
                              block_k=k.shape[1])


def flash_decode_paged(q, k, v, kpos, tables, pos, *, window: int = 0):
    """Ragged flash-decode over a paged KV block pool.

    Port of the JAX package's ``flash_decode_paged``.  q: (B,Sq,H,hd); k/v:
    (N, bl, KV, hd), a pool of N physical blocks of ``bl`` tokens (float32
    or bfloat16 storage), possibly a strided view (one layer of a
    layer-stacked pool) whose blocks each hold contiguous (bl, KV, hd)
    keys; kpos: (N, bl) int32 recorded positions (−1 = empty), unit stride
    inside a block; tables: (B, nmax) int32; pos: (B,) int32.  Returns
    (B,Sq,H,hd) in q.dtype, bit-identical to :func:`flash_decode` at
    ``block_k = bl`` on the gathered layout.

    CUDA tensors launch the kernel (``csrc/flash_decode_paged.cu``) or
    raise; CPU tensors take :func:`flash_decode_paged_plain`."""
    _build.refuse_grad("flash_decode_paged", q, k, v)
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k, v, kpos, tables, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged runs on cuda or cpu tensors, got {q.device}")
    return _flash_decode_paged_cuda(q, k, v, kpos, tables, pos, window=window)


def _flash_decode_paged_cuda(q, k, v, kpos, tables, pos, *, window):
    import ctypes

    b, sq, h, hd = q.shape
    n, bl, kvh = k.shape[0], k.shape[1], k.shape[2]
    nmax = tables.shape[1]
    esz = k.element_size()
    req = _build.require
    req(all(t.device == q.device for t in (k, v, kpos, tables, pos)), "all tensors on one device")
    req(k.shape == v.shape and k.ndim == 4 and k.shape[3] == hd,
        f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    req(k.dtype == v.dtype and k.stride() == v.stride(), "k and v share one dtype and layout")
    plan = paged_launch_plan(b, nmax, bl, sq, h, kvh, hd, q.dtype, k.dtype)
    req(tuple(k.stride()[1:]) == (kvh * hd, hd, 1),
        "each block's (bl, KV, hd) keys must be contiguous")
    loaded = (q, k, v) if plan["route"] == "mma" else (k, v)  # by 16-byte copies
    req(k.stride(0) * esz % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in loaded),
        "q (tensor-core body) and the k/v blocks must be 16-byte aligned (the kernel's loads)")
    req(tuple(kpos.shape) == (n, bl) and kpos.stride(1) == 1, "kpos (N, bl), unit stride in a block")
    req(tuple(tables.shape) == (b, nmax) and tuple(pos.shape) == (b,), "tables (B,nmax), pos (B,)")
    req(all(t.dtype == torch.int32 for t in (kpos, tables, pos)), "kpos/tables/pos are int32")
    req(all(t.is_contiguous() for t in (q, tables, pos)), "q, tables and pos contiguous")
    # Needed tiles on the device from the table-gathered positions (the
    # tile-skip math of the contiguous kernel on each slot's logical view);
    # the tensor-core route counts them through the table inside the kernel.
    nt = (needed_tiles(gather_pool(kpos, tables), pos, window=window, block_k=bl, sq=sq)
          if plan["route"] == "fma" else None)
    out = torch.empty_like(q)
    scratch = (torch.empty(plan["scratch_floats"], dtype=torch.float32, device=q.device)
               if plan["scratch_floats"] else None)
    fn = _build.kernel_fn("flash_decode_paged", "flash_decode_paged_launch",
                          [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
                          + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3
                          + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(), tables.data_ptr(),
                 pos.data_ptr(), nt.data_ptr() if nt is not None else None, out.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None, b, nmax, bl, sq, h, kvh,
                 hd, k.stride(0), kpos.stride(0), window, hd ** -0.5, _build.dtype_code(q),
                 _build.dtype_code(k), plan["chunks"], torch.cuda.current_stream().cuda_stream)
    _build.check("flash_decode_paged", err)
    _build.count("flash_decode_paged", multi_row=sq > 1)
    return out
