"""Row-invariant LayerNorm with bias: every ``layers.layer_norm`` of the
models under ``kernel_impl="cuda"`` (whisper-tiny's encoder and decoder).

The JAX package's ``layer_norm`` (``models/layers.py:22-28``) is plain
``jnp``; no Pallas kernel corresponds to this one.  As for ``rms_norm``,
PyTorch's last-dimension reductions pick their threads per row from the
number of rows, so a row's sums are added in another order at batch 1 than
at batch 8.  The CUDA kernel (``csrc/layer_norm.cu``) walks a row as
``csrc/rms_norm.cu`` does (``csrc/norm_rows.cuh``: a warp a row, chunks of
8 elements, lane l owning chunks l, l + 32, ..., a fixed shuffle tree) and
takes two sums in that order: the mean, then the centred squares, as
``jnp.var`` computes the variance.  :func:`repro_torch.kernels.rms_norm.plan`
gives the chunks a lane holds in registers, for both norms.

``layer_norm(x, weight, bias, eps)`` launches the kernel on CUDA tensors (or
raises) and runs ``layer_norm_plain`` on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rms_norm import _vpl



def layer_norm_plain(x, weight, bias, eps: float):
    """Mean, then the centred variance, in float32; the normalized row cast
    to x's dtype, *then* times weight, plus bias.  The CPU path, and the
    kernel's oracle on the card."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def layer_norm(x, weight, bias, eps: float):
    """x: (..., d); weight, bias: (d,) of x's dtype (float32 or bfloat16).
    Returns (..., d) in x's dtype.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`layer_norm_plain`."""
    _build.refuse_grad("layer_norm", x, weight, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cuda or cpu tensors, got {x.device}")
    return _layer_norm_cuda(x, weight, bias, eps)


def _layer_norm_cuda(x, weight, bias, eps):
    import ctypes

    d = x.shape[-1]
    req = _build.require
    req(weight.device == x.device and bias.device == x.device, "all tensors on one device")
    req(x.dtype == weight.dtype == bias.dtype,
        f"x, weight and bias share one dtype (got {x.dtype}, {weight.dtype}, {bias.dtype})")
    req(tuple(weight.shape) == (d,) and tuple(bias.shape) == (d,),
        f"weight {tuple(weight.shape)} and bias {tuple(bias.shape)} for rows of {d}")
    code = _build.dtype_code(x)
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0 or d == 0:
        return y
    w, b = weight.contiguous(), bias.contiguous()
    fn = _build.kernel_fn("layer_norm", "layer_norm_launch",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                          + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])
    with _build.on_device(x.device) as stream:
        err = fn(x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), rows, d,
                 x2.stride(0) if rows > 1 else d, eps, code, _vpl(d), stream)
    _build.check("layer_norm", err)
    _build.count("layer_norm")
    return y
