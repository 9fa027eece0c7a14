"""Mamba selective scan: the prefill recurrence of the ssm family.

Port of the JAX package's Pallas TPU kernel ``kernels/ssm_scan.py``
(``ssm_scan``, body ``_kernel``).  With dt already through softplus, per
time step and state element::

    h = exp(dt * A) * h + (dt * x) * B;   y = sum_n h * C

dt/x ``(B,S,di)``, B/C ``(B,S,N)``, A ``(di,N)``, h0 ``(B,di,N)``, all
float32; returns y ``(B,S,di)`` and h_last ``(B,di,N)`` in float32.

``ssm_scan`` launches the CUDA kernel (``csrc/ssm_scan.cu``) on CUDA tensors
and runs ``ssm_scan_plain``, the same recurrence as a loop over time in
PyTorch, on CPU tensors.  The kernel keeps the state in registers over the
whole sequence, so unlike the TPU kernel it needs no divisibility of S by a
chunk or of di by a block, and the model (``models/mamba.py``) sends it
every prefill of S > 1 under ``kernel_impl="cuda"``.
"""
from __future__ import annotations

import torch

MAX_STATE = 32  # N: the state lanes of one channel share a warp


def ssm_scan_plain(dt, x, b_mat, c_mat, a, h0):
    """The kernel's function in PyTorch: a loop over time in float32.  The
    CPU path, and the kernel's oracle on the card."""
    bsz, s, di = dt.shape
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=dt.device)
    h = h0.float()
    for t in range(s):
        dt_t = dt[:, t].float()
        h = torch.exp(dt_t[..., None] * a) * h + (dt_t * x[:, t])[..., None] * b_mat[:, t, None, :]
        y[:, t] = (h * c_mat[:, t, None, :]).sum(dim=-1)
    return y, h


def ssm_scan(dt, x, b_mat, c_mat, a, h0):
    """dt/x: (B,S,di); b_mat/c_mat: (B,S,N); a: (di,N); h0: (B,di,N); all
    float32.  Returns (y (B,S,di), h_last (B,di,N)) in float32.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`ssm_scan_plain`."""
    if dt.device.type == "cpu":
        return ssm_scan_plain(dt, x, b_mat, c_mat, a, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu tensors, got {dt.device}")
    return _ssm_scan_cuda(dt, x, b_mat, c_mat, a, h0)


def _ssm_scan_cuda(dt, x, b_mat, c_mat, a, h0):
    import ctypes

    from repro_torch.kernels import _build

    bsz, s, di = dt.shape
    n = a.shape[-1]
    ins = (dt, x, b_mat, c_mat, a, h0)
    req = _build.require
    req(all(t.device == dt.device for t in ins), "all tensors on one device")
    req(all(t.dtype == torch.float32 for t in ins), "the scan takes float32 tensors")
    req(tuple(x.shape) == (bsz, s, di), f"x {tuple(x.shape)} != dt {tuple(dt.shape)}")
    req(tuple(b_mat.shape) == (bsz, s, n) and tuple(c_mat.shape) == (bsz, s, n),
        f"B/C {tuple(b_mat.shape)}/{tuple(c_mat.shape)} are not (B,S,N) = {(bsz, s, n)}")
    req(tuple(a.shape) == (di, n) and tuple(h0.shape) == (bsz, di, n),
        f"A {tuple(a.shape)} / h0 {tuple(h0.shape)} are not (di,N) / (B,di,N)")
    req(all(t.is_contiguous() for t in ins), "contiguous tensors")
    req(0 < n <= MAX_STATE, f"N={n} outside 1..{MAX_STATE}")
    req(bsz * s * di > 0 and bsz <= 65535, f"B={bsz}, S={s}, di={di}")
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((bsz, di, n), dtype=torch.float32, device=dt.device)
    fn = _build.kernel_fn("ssm_scan", "ssm_scan_launch",
                          [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(dt.device):
        err = fn(dt.data_ptr(), x.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), a.data_ptr(),
                 h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), bsz, s, di, n,
                 torch.cuda.current_stream().cuda_stream)
    _build.check("ssm_scan", err)
    _build.LAUNCHES["ssm_scan"] += 1
    return y, h_last
