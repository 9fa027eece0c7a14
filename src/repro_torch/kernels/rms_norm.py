"""Row-invariant RMS normalization: every ``layers.rms_norm`` of the models
under ``kernel_impl="cuda"``.

The JAX package's ``rms_norm`` is plain ``jnp``; no Pallas kernel
corresponds to this one.  PyTorch's last-dimension mean picks its threads
per row from the number of rows, so a row's sum of squares is added in
another order at batch 1 than at batch 8.  The CUDA kernel
(``csrc/rms_norm.cu``) gives each row one warp and sums it in an order set
by its length alone: chunks of 8 elements, lane l owning chunks l, l + 32,
..., then a fixed shuffle tree.  :func:`plan` says how many chunks a lane
holds in registers between the sum and the scale.

``rms_norm(x, weight, eps)`` launches the kernel on CUDA tensors (or
raises) and runs ``rms_norm_plain`` on CPU tensors.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build


CHUNK = 8  # elements of one chunk: 16 bytes in bf16
VPL = (2, 4, 8, 10, 12, 16)  # the kernel's register-held chunks a lane


def plan(d: int) -> dict:
    """How the kernel sums a row of ``d`` elements: ``chunks`` of 8, lane
    l of the row's warp owning chunks l, l + 32, ... in ascending order
    (``per_lane`` of them at most), and ``vpl``, the instance that holds a
    lane's chunks in registers (0: the two-pass loop, for d > 4096).  A
    function of d alone: not of the rows, the dtype or the load path.  The
    wrapper passes ``vpl``."""
    chunks = -(-d // CHUNK)
    per_lane = -(-chunks // 32)
    vpl = next((v for v in VPL if v >= per_lane), 0)
    return dict(chunks=chunks, per_lane=per_lane, vpl=vpl)


def rms_norm_plain(x, weight, eps: float):
    """Normalize in float32, cast back to x's dtype, *then* scale.  The CPU
    path, and the kernel's oracle on the card."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rms_norm(x, weight, eps: float):
    """x: (..., d); weight: (d,) of x's dtype (float32 or bfloat16).
    Returns (..., d) in x's dtype.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`rms_norm_plain`."""
    _build.refuse_grad("rms_norm", x, weight)
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu tensors, got {x.device}")
    return _rms_norm_cuda(x, weight, eps)


@functools.lru_cache(maxsize=256)
def _vpl(d: int) -> int:
    return plan(d)["vpl"]


def _rms_norm_cuda(x, weight, eps):
    import ctypes

    d = x.shape[-1]
    if weight.device != x.device:
        raise ValueError("all tensors on one device")
    if x.dtype != weight.dtype:
        raise ValueError(f"x and weight share one dtype (got {x.dtype}, {weight.dtype})")
    if tuple(weight.shape) != (d,):
        raise ValueError(f"weight {tuple(weight.shape)} for rows of {d}")
    code = _build.dtype_code(x)
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0 or d == 0:
        return y
    w = weight.contiguous()
    fn = _build.kernel_fn("rms_norm", "rms_norm_launch",
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                          + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])
    with _build.on_device(x.device) as stream:
        err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
                 x2.stride(0) if rows > 1 else d, eps, code, _vpl(d), stream)
    _build.check("rms_norm", err)
    _build.count("rms_norm")
    return y
