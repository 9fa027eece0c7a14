"""FlashAttention forward: prefill attention.

Port of the JAX package's Pallas TPU kernel ``kernels/flash_attention.py``
(``flash_attention`` → ``_flash_fwd_impl``, body ``_kernel``): q
``(B,Sq,H,hd)``, k/v ``(B,Sk,KV,hd)``; causal with ``q_offset``, sliding
window or bidirectional; GQA reads kv head ``h // n_rep``; online softmax
over KV tiles in float32 with p cast to v's dtype before PV; tiles outside
the mask are skipped.  ``prefix_len`` P > 0 makes the causal mask a
prefix-LM one, PaliGemma's prefill (the JAX package's
``models/attention.py:_prefix_lm_attention``, plain ``jnp`` there): rows
inside the first P positions see all of them, so a row at p sees keys up to
max(p, P - 1), and the window does not cut the prefix for its rows.

``flash_attention`` launches the CUDA kernel (``csrc/flash_attention.cu``)
on CUDA tensors and runs ``flash_attention_plain``, the same tiles and masks
as a loop in PyTorch, on CPU tensors.

Where autograd needs it (grad mode on and an input requiring grad) the call
goes through :class:`FlashAttention`, the counterpart of the reference's
``custom_vjp`` (``_flash_vjp``): the forward is the kernel's output, bit for
bit, with (q, k, v), the output and each row's log-sum-exp saved; the
backward is :func:`flash_attention_bwd`, FlashAttention-2's gradient from
that log-sum-exp (``csrc/flash_attention_bwd.cu`` on CUDA tensors,
:func:`flash_attention_bwd_plain` on CPU tensors), which computes the
gradient of the same masked attention that the reference's ``_flash_vjp_bwd``
takes of its ``jnp`` recompute.  :func:`recompute`, that recompute in
PyTorch, is the parent design's backward, kept as the card's yardstick.

The kernel has two bodies (:func:`launch_plan` says which a shape takes):

- bfloat16 at hd 64/112/128/256 runs on the tensor cores (``mma.sync``, K/V
  tiles by ``cp.async`` two stages deep, ``csrc/attention_mma.cuh``): a
  block owns 64 rows, 16 per warp, which interleave the query positions
  with G heads of one kv group (G the largest divisor of n_rep up to 16);
  ``block_q`` does not apply, ``block_k`` sets the tile range's grain;
- float32, and bfloat16 at other head sizes, runs the float FMA body
  (``attend_rows``) on tiles of ``block_q`` x ``block_k`` (64 x 64 by
  default; the TPU kernel's are 128 x 128).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# The reference backward recomputes densely up to this many (query, key)
# pairs, and in chunks beyond (``_flash_vjp_bwd``).
RECOMPUTE_NAIVE_MAX = 1024 * 1024
# The prefill kernel's KV tile: its tile partition is the one chunked
# prefill's rows (``flash_decode.flash_decode_chunk``) walk as well.
BLOCK_K = 64


def _tile_range(first: int, last: int, sk: int, bk: int, causal: bool, window: int,
                prefix_len: int = 0):
    """KV tiles [lo, hi) that rows at positions first..last can reach (rows
    inside a prefix of ``prefix_len`` positions reach all of it)."""
    kv_end = min(sk, max(last, prefix_len - 1) + 1) if causal else sk
    kv_begin = max(0, first - window + 1) if window > 0 and first >= prefix_len else 0
    lo = kv_begin // bk
    hi = -(-kv_end // bk) if kv_end > kv_begin else lo
    return lo, hi


def _valid(qpos, kpos, causal: bool, window: int, prefix_len: int):
    """(rows, keys) mask of the kernels: causal and window limits, a prefix
    of ``prefix_len`` positions that its rows see whole."""
    valid = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    pre = (qpos[:, None] < prefix_len) & (kpos[None, :] < prefix_len)
    if causal:
        valid &= (kpos[None, :] <= qpos[:, None]) | pre
    if window > 0:
        valid &= (kpos[None, :] > qpos[:, None] - window) | pre
    return valid


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, prefix_len: int = 0, block_q: int = 64,
                          block_k: int = BLOCK_K, return_lse: bool = False):
    """The kernel's function in PyTorch: per q tile, a loop over the KV
    tiles its rows can reach, with the kernel's masks, float32 online
    softmax and explicit p = 0 for masked keys.  The CPU path, and the
    kernel's oracle on the card.  ``return_lse``: also each row's
    log-sum-exp of its scaled scores in base 2, (B, Sq, H) float32, as the
    kernel saves it for the backward (the output is the same either way)."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    scale = hd ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device) if return_lse else None
    for q0 in range(0, sq, block_q):
        rows = min(block_q, sq - q0)
        first = q0 + q_offset
        qg = q[:, q0:q0 + rows].reshape(b, rows, kvh, n_rep, hd).float()
        qpos = first + torch.arange(rows, device=q.device)
        m = torch.full((b, h, rows), NEG_INF, device=q.device)
        l = torch.zeros((b, h, rows), device=q.device)
        acc = torch.zeros((b, h, rows, hd), device=q.device)
        lo, hi = _tile_range(first, first + rows - 1, sk, block_k, causal, window, prefix_len)
        for t in range(lo, hi):
            kb = k[:, t * block_k:(t + 1) * block_k]
            vb = v[:, t * block_k:(t + 1) * block_k]
            kc = kb.shape[1]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb.float()).reshape(b, h, rows, kc)
            s = s * scale
            kpos = t * block_k + torch.arange(kc, device=q.device)
            valid = _valid(qpos, kpos, causal, window, prefix_len)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pg = p.to(v.dtype).float().reshape(b, kvh, n_rep, rows, kc)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", pg, vb.float())
            acc = acc * alpha[..., None] + pv.reshape(b, h, rows, hd)
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + rows] = o.transpose(1, 2).to(q.dtype)
        if return_lse:
            lse[:, q0:q0 + rows] = (m * LOG2E + torch.log2(torch.clamp(l, min=1e-30))
                                    ).transpose(1, 2)
    return (out, lse) if return_lse else out


def _inverse_tile_range(t: int, n_rows: int, bq: int, bk: int, sk: int, causal: bool,
                        window: int, q_offset: int = 0, prefix_len: int = 0, div: int = 1):
    """Row tiles [lo, hi) of ``bq`` rows (row r at position q_offset + r //
    div, ``n_rows`` rows) whose :func:`_tile_range` reaches key tile ``t``
    of ``bk`` keys: the backward's key-major walk (``inverse_tile_range`` in
    ``csrc/attention_tile.cuh``, the same two binary searches).  A tile's
    range [x, y) has x growing with the tile and is empty only where its
    window starts at or past Sk, as is every later tile's; so the tiles with
    x <= t and a range form a prefix, within which y grows."""
    def rng(i):
        r0 = i * bq
        return _tile_range(q_offset + r0 // div, q_offset + (min(r0 + bq, n_rows) - 1) // div,
                           sk, bk, causal, window, prefix_len)

    lo, hi = 0, -(-n_rows // bq)
    while lo < hi:
        mid = (lo + hi) // 2
        x, y = rng(mid)
        if x <= t and x < y:
            lo = mid + 1
        else:
            hi = mid
    end = lo
    lo, hi = 0, end
    while lo < hi:
        mid = (lo + hi) // 2
        if rng(mid)[1] > t:
            hi = mid
        else:
            lo = mid + 1
    return lo, end


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool = True, window: int = 0,
                              q_offset: int = 0, prefix_len: int = 0, block_q: int = 64,
                              block_k: int = BLOCK_K):
    """The backward kernel's function in PyTorch: dq, dk, dv of
    :func:`flash_attention_plain`'s attention at ``do``, from its output
    and ``lse`` ((B, Sq, H) float32: each row's log-sum-exp in base 2, P =
    exp2(S scale log2 e - lse)), FlashAttention-2 style in float32 in the
    kernel's two walks: q-major over each q tile's :func:`_tile_range`
    for dq (a first sweep sums each row's D = rowsum(P * dP) / rowsum(P), P
    in float32, so that each row's dS sums to zero as the reference's
    softmax backward's does, the second forms dS = P * (dP - D) and dq),
    key-major over each key tile's :func:`_inverse_tile_range` for dk and
    dv (the n_rep heads of a kv group summed in the products).  P and dS
    are rounded to q's dtype for their products, as the kernel rounds them.
    ``out`` is not read: D comes from P and dP (the float32 FMA route's
    rowsum(dO * out) is the same sum in float32).  The CPU path of the
    autograd Function's backward, and the kernel's oracle on the card."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    scale = hd ** -0.5
    dev = q.device
    rnd = lambda x: x.to(q.dtype).float()  # noqa: E731

    def tile_pair(q0, rows, t):
        """P and dP of q rows q0..q0+rows against key tile t, (b, kvh,
        n_rep, rows, keys), and those rows' q and dO and the tile's keys in
        float32."""
        kb = k[:, t * block_k:(t + 1) * block_k].float()
        vb = v[:, t * block_k:(t + 1) * block_k].float()
        qg = q[:, q0:q0 + rows].reshape(b, rows, kvh, n_rep, hd).float()
        dog = do[:, q0:q0 + rows].reshape(b, rows, kvh, n_rep, hd).float()
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb) * (scale * LOG2E)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vb)
        qpos = q0 + q_offset + torch.arange(rows, device=dev)
        kpos = t * block_k + torch.arange(kb.shape[1], device=dev)
        valid = _valid(qpos, kpos, causal, window, prefix_len)
        st = lse[:, q0:q0 + rows].reshape(b, rows, kvh, n_rep).permute(0, 2, 3, 1)[..., None]
        p = torch.where(valid, torch.exp2(s - st), 0.0)
        return p, dp, qg, dog, kb

    def row_d(q0, rows):  # (b, kvh, n_rep, rows, 1)
        return dsum[:, q0:q0 + rows].reshape(b, rows, kvh, n_rep).permute(0, 2, 3, 1)[..., None]

    dsum = torch.zeros((b, sq, h), dtype=torch.float32, device=dev)
    dq = torch.zeros((b, sq, kvh, n_rep, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, block_q):
        rows = min(block_q, sq - q0)
        first = q0 + q_offset
        lo, hi = _tile_range(first, first + rows - 1, sk, block_k, causal, window, prefix_len)
        d = torch.zeros((b, kvh, n_rep, rows), dtype=torch.float32, device=dev)
        mass = torch.zeros_like(d)
        for t in range(lo, hi):
            p, dp, *_ = tile_pair(q0, rows, t)
            d += (p * dp).sum(dim=-1)
            mass += p.sum(dim=-1)
        d = torch.where(mass > 0, d / torch.where(mass > 0, mass, 1.0), 0.0)
        dsum[:, q0:q0 + rows] = d.permute(0, 3, 1, 2).reshape(b, rows, h)
        for t in range(lo, hi):
            p, dp, _, _, kb = tile_pair(q0, rows, t)
            ds = rnd(p * (dp - row_d(q0, rows)))
            dq[:, q0:q0 + rows] += torch.einsum("bgrqk,bkgd->bqgrd", ds, kb)
    dk = torch.zeros((b, sk, kvh, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for t in range(-(-sk // block_k)):
        k0 = t * block_k
        lo, hi = _inverse_tile_range(t, sq, block_q, block_k, sk, causal, window, q_offset,
                                     prefix_len)
        for i in range(lo, hi):
            q0 = i * block_q
            rows = min(block_q, sq - q0)
            p, dp, qg, dog, _ = tile_pair(q0, rows, t)
            ds = rnd(p * (dp - row_d(q0, rows)))
            dv[:, k0:k0 + block_k] += torch.einsum("bgrqk,bqgrd->bkgd", rnd(p), dog)
            dk[:, k0:k0 + block_k] += torch.einsum("bgrqk,bqgrd->bkgd", ds, qg)
    return ((dq * scale).reshape(b, sq, h, hd).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def heads_per_block(n_rep: int) -> int:
    """Heads of one kv group that share a tensor-core block: the largest
    divisor of n_rep up to 16 (``heads_per_block`` in the source)."""
    return max(d for d in range(1, min(n_rep, 16) + 1) if n_rep % d == 0)


def launch_plan(b: int, sq: int, sk: int, h: int, kv: int, hd: int, dtype, *,
                block_q: int = 64, block_k: int = BLOCK_K, prefix_len: int = 0) -> dict:
    """Shape admission of the CUDA kernel, as ``flash_attention_launch``
    checks it: the body (``"mma"`` or ``"fma"``), tile sizes, grid and
    dynamic shared memory of a launch.  Raises ValueError on a shape the
    kernel cannot take.  Pure: the CPU tests call it."""
    from repro_torch.kernels import _build

    req = _build.require
    req(min(b, sq, sk, h, kv, hd) > 0, "empty shape")
    req(prefix_len >= 0, f"prefix_len={prefix_len} < 0")
    req(h % kv == 0, f"H={h} is not a multiple of KV={kv}")
    req(dtype in _build.DTYPE_CODES, f"kernel takes float32 or bfloat16, got {dtype}")
    req(hd * (4 if dtype == torch.float32 else 2) % 16 == 0,
        f"hd={hd}: rows must be whole 16-byte vectors (the kernel's loads)")
    bq, bk = min(block_q, sq), min(block_k, sk)
    req(0 < bq <= _build.MAX_ROWS, f"block_q={bq} outside 1..{_build.MAX_ROWS}")
    req(0 < bk <= _build.MAX_BLOCK_K, f"block_k={bk} outside 1..{_build.MAX_BLOCK_K}")
    if _build.uses_mma(dtype, _build.MMA_ROWS, bk, hd):
        g = heads_per_block(h // kv)
        grid = (b * h // g, -(-sq * g // _build.MMA_ROWS))
        smem = _build.mma_smem_bytes(_build.MMA_ROWS, bk, hd)
        plan = dict(route="mma", rows=_build.MMA_ROWS, heads_per_block=g,
                    stage_keys=_build.mma_plan(_build.MMA_ROWS, bk, hd)[1])
    else:
        grid = (-(-sq // bq), b * h)
        smem = _build.smem_bytes(bq, hd, bk)
        plan = dict(route="fma", rows=bq)
    req(grid[1] <= 65535, f"{grid[1]} blocks on the grid's second axis > 65535")
    req(grid[0] < 2**31, f"{grid[0]} blocks on the grid's first axis")
    req(smem <= _build.MAX_SMEM, f"hd={hd} too wide: {smem} bytes of shared memory")
    return dict(plan, block_q=bq, block_k=bk, grid=grid, smem=smem)


# The backward's tensor-core passes (csrc/flash_attention_bwd.cu): bf16 at
# these head sizes; 4-warp dq blocks of the forward's 64 rows; 8-warp dk/dv
# blocks of BWD_ROWS-row tiles.
BWD_MMA_HEAD_DIMS = (64, 128, 256)
BWD_ROWS = 64
BWD_FMA_TILE = 32  # rows and keys of the FMA route's tiles


def _bwd_mma_tiles(hd: int):
    """(keys a dq stage, keys a dk/dv block): 64 and 64, or 32 and 32 at hd
    256, where the registers and shared memory bind."""
    return (32, 32) if hd > 128 else (64, 64)


def backward_plan(b: int, sq: int, sk: int, h: int, kv: int, hd: int, dtype) -> dict:
    """Shape admission of the backward kernel, as ``flash_attention_bwd_launch``
    checks it: the route (``"mma"`` or ``"fma"``), and for each of its two
    passes (``dq``, ``dkdv``) the tiles, grid, threads and dynamic shared
    memory.  Raises ValueError on a shape the kernel cannot take.  Pure:
    the CPU tests call it."""
    from repro_torch.kernels import _build

    req = _build.require
    req(min(b, sq, sk, h, kv, hd) > 0, "empty shape")
    req(h % kv == 0, f"H={h} is not a multiple of KV={kv}")
    req(dtype in _build.DTYPE_CODES, f"kernel takes float32 or bfloat16, got {dtype}")
    req(hd * (4 if dtype == torch.float32 else 2) % 16 == 0,
        f"hd={hd}: rows must be whole 16-byte vectors (the kernel's loads)")
    n_rep = h // kv
    if dtype == torch.bfloat16 and hd in BWD_MMA_HEAD_DIMS:
        sb, bkk = _bwd_mma_tiles(hd)
        ld, lp = hd + _build.MMA_PAD, BWD_ROWS + _build.MMA_PAD
        g = heads_per_block(n_rep)
        dq = dict(rows=_build.MMA_ROWS, heads_per_block=g, stage_keys=sb, block_k=BLOCK_K,
                  threads=32 * _build.MMA_WARPS,
                  grid=(b * h // g, -(-sq * g // _build.MMA_ROWS)),
                  smem=(2 * _build.MMA_ROWS * ld + 4 * sb * ld) * 2 + 2 * sb * 4 + 16
                  + _build.MMA_ROWS * 4)
        dkdv = dict(block_k=bkk, rows=BWD_ROWS, threads=256, grid=(b * kv, -(-sk // bkk)),
                    smem=(2 * bkk * ld + 4 * BWD_ROWS * ld + 2 * bkk * lp) * 2
                    + 6 * BWD_ROWS * 4)
        route = "mma"
    else:
        t = BWD_FMA_TILE
        dq = dict(rows=t, block_k=t, threads=256, grid=(-(-sq // t), b * h),
                  smem=4 * (2 * hd * (t + 4) + t * hd + 2 * t * (hd + 1) + t * (t + 4) + 2 * t)
                  + 4 * t)
        dkdv = dict(block_k=t, rows=t, threads=256, grid=(-(-sk // t), b * kv),
                    smem=4 * (2 * hd * (t + 4) + 2 * t * (hd + 1) + 2 * t * hd + 2 * t * (t + 4)
                              + 2 * t))
        route = "fma"
    for name, pas in (("dq", dq), ("dk/dv", dkdv)):
        gy = pas["grid"][1]
        req(gy <= 65535, f"{gy} blocks on the {name} pass's second grid axis > 65535")
        req(pas["smem"] <= _build.MAX_SMEM,
            f"hd={hd} too wide: {pas['smem']} bytes of shared memory in the {name} pass")
    return dict(route=route, dq=dq, dkdv=dkdv)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                    prefix_len: int = 0, block_q: int = 64, block_k: int = BLOCK_K):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd) with H % KV == 0, one dtype
    (float32 or bfloat16).  Returns (B,Sq,H,hd).  ``prefix_len`` > 0: the
    prefix-LM mask (see the module's docstring).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`flash_attention_plain`.  Under autograd (grad mode on and an
    input requiring grad) the call goes through :class:`FlashAttention`,
    whose forward is the same dispatch."""
    args = (causal, window, q_offset, prefix_len, block_q, block_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, *args)
    return _dispatch(q, k, v, *args)


def _dispatch(q, k, v, causal, window, q_offset, prefix_len, block_q, block_k, lse=False):
    kw = dict(causal=causal, window=window, q_offset=q_offset, prefix_len=prefix_len,
              block_q=block_q, block_k=block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, return_lse=lse, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    return _flash_attention_cuda(q, k, v, lse=lse, **kw)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, prefix_len: int = 0, block_q: int = 64,
                        block_k: int = BLOCK_K):
    """dq, dk, dv of :func:`flash_attention` at ``do`` (q's shape and
    dtype), from the forward's output and each row's log-sum-exp ``lse``
    ((B, Sq, H) float32, base 2, as ``flash_attention_plain(...,
    return_lse=True)`` and the kernel's autograd forward give it).  The
    autograd Function's
    backward.  A prefix-LM call covers a whole sequence (Sq = Sk, q_offset
    0) and raises outside it.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`flash_attention_bwd_plain`."""
    from repro_torch.kernels import _build

    _build.refuse_grad("flash_attention_bwd", q, k, v, out, lse, do)
    kw = dict(causal=causal, window=window, q_offset=q_offset, prefix_len=prefix_len,
              block_q=block_q, block_k=block_k)
    if prefix_len > 0 and (q_offset or q.shape[1] != k.shape[1]):
        raise ValueError("the prefix-LM backward covers a whole sequence (Sq = Sk, q_offset "
                         f"0); got Sq {q.shape[1]}, Sk {k.shape[1]}, q_offset {q_offset}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, got {q.device}")
    return _flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)


def recompute(q, k, v, *, causal: bool, window: int, q_offset: int, prefix_len: int):
    """Attention in PyTorch as the reference's backward recomputes it:
    ``naive_attention`` where Sq·Sk <= 2^20, else ``chunked_attention``
    with chunks of min(1024, S); a prefix-LM call (Sq = Sk, no offset)
    through ``_prefix_lm_attention``.  The parent design's backward took
    the gradient of this; no train path calls it now (the card's yardstick
    and its own test keep it)."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L

    sq, sk = q.shape[1], k.shape[1]
    if prefix_len > 0:
        if q_offset or sq != sk:
            raise ValueError("the prefix-LM backward recomputes a whole sequence (Sq = Sk, "
                             f"q_offset 0); got Sq {sq}, Sk {sk}, q_offset {q_offset}")
        return A._prefix_lm_attention(q, k, v, prefix_len, window)
    if sq * sk <= RECOMPUTE_NAIVE_MAX:
        return L.naive_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return L.chunked_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               q_chunk=min(1024, sq), kv_chunk=min(1024, sk))


class FlashAttention(torch.autograd.Function):
    """The kernel's forward, saving its output and each row's log-sum-exp,
    and :func:`flash_attention_bwd` as the backward (see the module's
    docstring).  ``apply(q, k, v, causal, window, q_offset, prefix_len,
    block_q, block_k)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, prefix_len, block_q, block_k):
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset, prefix_len=prefix_len,
                        block_q=block_q, block_k=block_k)
        # The kernel loads contiguous rows; a caller's q, k or v may be a view.
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _dispatch(qc, kc, vc, causal, window, q_offset, prefix_len, block_q, block_k,
                             True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out,
                                         lse, g.contiguous(), **ctx.args)
        return (dq, dk, dv) + (None,) * 6


def _flash_attention_cuda(q, k, v, *, causal, window, q_offset, prefix_len, block_q,
                          block_k, lse=False):
    """The forward kernel's launch; ``lse``: also return each row's
    log-sum-exp ((B, Sq, H) float32, base 2), which only the autograd
    forward asks for (every inference launch passes a null pointer)."""
    import ctypes

    from repro_torch.kernels import _build

    _build.refuse_grad("flash_attention", q, k, v)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    req = _build.require
    req(k.device == q.device and v.device == q.device, "all tensors on one device")
    req(k.shape == v.shape and k.shape[0] == b and k.shape[3] == hd,
        f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    req(q.dtype == k.dtype == v.dtype, "q, k and v share one dtype")
    plan = launch_plan(b, sq, sk, h, kvh, hd, q.dtype, block_q=block_q, block_k=block_k,
                       prefix_len=prefix_len)
    loaded = (q, k, v) if plan["route"] == "mma" else (k, v)  # by 16-byte copies
    req(all(t.data_ptr() % 16 == 0 for t in loaded),
        "q (tensor-core body) and k/v must be 16-byte aligned (the kernel's loads)")
    req(all(t.is_contiguous() for t in (q, k, v)), "contiguous tensors")
    out = torch.empty_like(q)
    row_lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device) if lse else None
    fn = _build.kernel_fn("flash_attention", "flash_attention_launch",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_float]
                          + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 row_lse.data_ptr() if lse else None, b, sq, sk, h, kvh, hd, plan["block_q"],
                 plan["block_k"], int(causal), window, q_offset, prefix_len, hd ** -0.5,
                 _build.dtype_code(q), torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", err)
    _build.count("flash_attention")
    return (out, row_lse) if lse else out


def _flash_attention_bwd_cuda(q, k, v, out, lse, do, *, causal, window, q_offset, prefix_len,
                              block_q, block_k):
    """The backward kernel's launch (both passes): fresh dq, dk, dv and D's
    scratch from ``torch.empty`` on the current stream, no host sync, so a
    CUDA graph captures it."""
    import ctypes

    from repro_torch.kernels import _build

    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    req = _build.require
    req(all(t.device == q.device for t in (k, v, out, lse, do)), "all tensors on one device")
    req(k.shape == v.shape and k.shape[0] == b and k.shape[3] == hd,
        f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    req(out.shape == q.shape and do.shape == q.shape, "out and do have q's shape")
    req(q.dtype == k.dtype == v.dtype == out.dtype == do.dtype,
        "q, k, v, out and do share one dtype")
    req(lse.dtype == torch.float32 and tuple(lse.shape) == (b, sq, h),
        f"lse {tuple(lse.shape)} {lse.dtype}: (B, Sq, H) float32")
    backward_plan(b, sq, sk, h, kvh, hd, q.dtype)
    req(all(t.is_contiguous() for t in (q, k, v, out, lse, do)), "contiguous tensors")
    req(all(t.data_ptr() % 16 == 0 for t in (q, k, v, do)),
        "q, k, v and do must be 16-byte aligned (the kernel's loads)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    fn = _build.kernel_fn("flash_attention_bwd", "flash_attention_bwd_launch",
                          [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float]
                          + [ctypes.c_int, ctypes.c_void_p])
    with _build.on_device(q.device) as stream:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(),
                 b, sq, sk, h, kvh, hd, int(causal), window, q_offset, prefix_len, hd ** -0.5,
                 _build.dtype_code(q), stream)
    _build.check("flash_attention_bwd", err)
    _build.count("flash_attention_bwd")
    return dq, dk, dv
