"""Row-invariant matrix product: every product of the models whose rows
could depend on the batch (projections, MLPs, the head, recurrentgemma's
block-diagonal gates).

The JAX package computes these products with plain ``jnp`` einsums; no
Pallas kernel corresponds to this one.  It exists for the contract that a
served stream equals one-shot generate of its request alone, bitwise: the
CUDA kernel (``csrc/gemm_rowinv.cu``) sums every output element over K in
an order fixed by K alone, so a row of ``x`` gives the same bits at any M.

``linear(x, w, bias)`` launches the kernel on CUDA tensors (or raises) and
runs ``linear_plain``, ``torch.matmul`` plus the bias, on CPU tensors.
"""
from __future__ import annotations

import torch


def linear_plain(x, w, bias=None):
    """The kernel's function in PyTorch: ``x @ w`` for a 2-D ``w`` (K, N);
    for a 3-D block-diagonal ``w`` (nb, K, N), ``x`` (..., nb, K) times each
    block.  The bias is added to the product in its dtype, as the models
    add it.  The CPU path, and the kernel's oracle on the card."""
    y = x @ w if w.dim() == 2 else torch.einsum("...nk,nkv->...nv", x, w)
    return y if bias is None else y + bias


def linear(x, w, bias=None):
    """x: (..., K) and w: (K, N), or x: (..., nb, K) and w: (nb, K, N) (one
    product per block, one launch); bias: (N,) or (nb, N).  One dtype,
    float32 or bfloat16.  Returns (..., N) or (..., nb, N) in x's dtype.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`linear_plain`."""
    if x.device.type == "cpu":
        return linear_plain(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"linear runs on cuda or cpu tensors, got {x.device}")
    return _linear_cuda(x, w, bias)


def operands(x, w, bias=None) -> dict:
    """How ``linear`` hands x, w and bias to the kernel: the 2-D views
    and the strides it passes (``x2``, ``w2``, ``m``, ``n``, ``k``, ``lda``,
    ``ldw``, ``ldy``, ``batch``, ``sx``, ``sw``, ``sb``, ``sy``, ``wt``,
    ``out_shape``).  Views where the layout allows it, copies otherwise.
    ``wt`` = 1 when w is stored transposed, (N, K) row-major (a tied head's
    ``embed.T``).  Pure: the CPU tests call it."""
    from repro_torch.kernels import _build

    req = _build.require
    if w.dim() == 2:
        k, n = w.shape
        req(x.shape[-1] == k, f"x {tuple(x.shape)} does not match w {tuple(w.shape)}")
        batch, blocks = 1, ()
        x2 = x.reshape(-1, k)
        sx = sw = sb = sy = 0
        ldy = n
        if w.stride(1) == 1 and w.stride(0) >= n:
            w2, wt, ldw = w, 0, w.stride(0)
        elif w.stride(0) == 1 and w.stride(1) >= k:
            w2, wt, ldw = w, 1, w.stride(1)
        else:
            w2, wt, ldw = w.contiguous(), 0, n
    else:
        nb, k, n = w.shape
        req(x.dim() >= 2 and tuple(x.shape[-2:]) == (nb, k),
            f"x {tuple(x.shape)} does not match block weights {tuple(w.shape)}")
        batch, blocks = nb, (nb,)
        x2 = x.reshape(-1, nb, k)
        w2, wt, ldw = w.contiguous(), 0, n
        sw, sb, sy, ldy = k * n, n, n, nb * n
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    m = x2.shape[0]
    lda = x2.stride(0) if m > 1 else batch * k
    if batch > 1:
        sx = x2.stride(1)
    if bias is not None:
        req(tuple(bias.shape) == blocks + (n,),
            f"bias {tuple(bias.shape)} does not match the output's {blocks + (n,)}")
    return dict(x2=x2, w2=w2, m=m, n=n, k=k, lda=lda, ldw=ldw, ldy=ldy, batch=batch,
                sx=sx, sw=sw, sb=sb, sy=sy, wt=wt, out_shape=tuple(x.shape[:-1]) + (n,))


def _linear_cuda(x, w, bias):
    import ctypes

    from repro_torch.kernels import _build

    req = _build.require
    req(w.device == x.device and (bias is None or bias.device == x.device),
        "all tensors on one device")
    req(x.dtype == w.dtype and (bias is None or bias.dtype == x.dtype),
        f"x, w and bias share one dtype (got {x.dtype}, {w.dtype}"
        f"{'' if bias is None else ', ' + str(bias.dtype)})")
    code = _build.dtype_code(x)
    o = operands(x, w, bias)
    y = torch.empty(o["out_shape"], dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    req(o["k"] > 0, "K = 0")
    b = None if bias is None else bias.contiguous()
    fn = _build.kernel_fn("gemm_rowinv", "gemm_rowinv_launch",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                          + [ctypes.c_longlong] * 3 + [ctypes.c_int]
                          + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2
                          + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(o["x2"].data_ptr(), o["w2"].data_ptr(), 0 if b is None else b.data_ptr(),
                 y.data_ptr(), o["m"], o["n"], o["k"], o["lda"], o["ldw"], o["ldy"],
                 o["batch"], o["sx"], o["sw"], o["sb"], o["sy"], o["wt"], code,
                 torch.cuda.current_stream().cuda_stream)
    _build.check("gemm_rowinv", err)
    _build.count("gemm_rowinv")
    return y
