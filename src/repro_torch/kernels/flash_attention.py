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
bit, with (q, k, v) saved; the backward recomputes attention in PyTorch and
takes the gradient of that recompute, as ``_flash_vjp_bwd`` does
(:func:`recompute`): ``layers.naive_attention`` where Sq·Sk <= 2^20, else
``layers.chunked_attention`` in chunks of 1024, and for a prefix-LM call
``models/attention.py:_prefix_lm_attention``, the reference's own
computation of that mask.  No kernel runs in the backward.

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


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, prefix_len: int = 0, block_q: int = 64,
                          block_k: int = BLOCK_K):
    """The kernel's function in PyTorch: per q tile, a loop over the KV
    tiles its rows can reach, with the kernel's masks, float32 online
    softmax and explicit p = 0 for masked keys.  The CPU path, and the
    kernel's oracle on the card."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    scale = hd ** -0.5
    out = torch.empty_like(q)
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
            valid = torch.ones((rows, kc), dtype=torch.bool, device=q.device)
            pre = (qpos[:, None] < prefix_len) & (kpos[None, :] < prefix_len)
            if causal:
                valid &= (kpos[None, :] <= qpos[:, None]) | pre
            if window > 0:
                valid &= (kpos[None, :] > qpos[:, None] - window) | pre
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
    return out


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


def _dispatch(q, k, v, causal, window, q_offset, prefix_len, block_q, block_k):
    kw = dict(causal=causal, window=window, q_offset=q_offset, prefix_len=prefix_len,
              block_q=block_q, block_k=block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    return _flash_attention_cuda(q, k, v, **kw)


def recompute(q, k, v, *, causal: bool, window: int, q_offset: int, prefix_len: int):
    """Attention in PyTorch as the reference's backward recomputes it:
    ``naive_attention`` where Sq·Sk <= 2^20, else ``chunked_attention``
    with chunks of min(1024, S); a prefix-LM call (Sq = Sk, no offset)
    through ``_prefix_lm_attention``."""
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
    """The kernel's forward with the reference's recompute backward (see
    the module's docstring).  ``apply(q, k, v, causal, window, q_offset,
    prefix_len, block_q, block_k)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, prefix_len, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset, prefix_len=prefix_len)
        # The kernel loads contiguous rows; a caller's q, k or v may be a view.
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return _dispatch(q, k, v, causal, window, q_offset, prefix_len, block_q, block_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = recompute(q, k, v, **ctx.mask)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return (dq, dk, dv) + (None,) * 6


def _flash_attention_cuda(q, k, v, *, causal, window, q_offset, prefix_len, block_q,
                          block_k):
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
    fn = _build.kernel_fn("flash_attention", "flash_attention_launch",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_float]
                          + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, kvh, hd, plan["block_q"], plan["block_k"], int(causal), window,
                 q_offset, prefix_len, hd ** -0.5, _build.dtype_code(q),
                 torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", err)
    _build.count("flash_attention")
    return out
