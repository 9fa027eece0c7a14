"""RG-LRU diagonal linear recurrence: the prefill recurrence of the hybrid
family.

Port of the JAX package's Pallas TPU kernel ``kernels/rglru_scan.py``
(``rglru_scan``, body ``_kernel``): ``h_t = a_t * h_{t-1} + b_t`` over
``(B,S,W)`` in float32 from h0 ``(B,W)``; returns every h_t ``(B,S,W)`` and
h_last ``(B,W)``.

``rglru_scan`` launches the CUDA kernel (``csrc/rglru_scan.cu``) on CUDA
tensors and runs ``rglru_scan_plain``, the same recurrence as a loop over
time in PyTorch, on CPU tensors.  The kernel takes any B, S and W, so the
model (``models/rglru.py``) sends it every prefill of S > 1 under
``kernel_impl="cuda"``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build



def rglru_scan_plain(a, b, h0):
    """The kernel's function in PyTorch: a loop over time in float32.  The
    CPU path, and the kernel's oracle on the card."""
    hs = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = h0.float()
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        hs[:, t] = h
    return hs, h


def rglru_scan(a, b, h0):
    """a/b: (B,S,W); h0: (B,W); all float32.  Returns (hs (B,S,W),
    h_last (B,W)) in float32.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`rglru_scan_plain`."""
    _build.refuse_grad("rglru_scan", a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, got {a.device}")
    return _rglru_scan_cuda(a, b, h0)


def _rglru_scan_cuda(a, b, h0):
    import ctypes

    bsz, s, w = a.shape
    ins = (a, b, h0)
    req = _build.require
    req(all(t.device == a.device for t in ins), "all tensors on one device")
    req(all(t.dtype == torch.float32 for t in ins), "the scan takes float32 tensors")
    req(tuple(b.shape) == (bsz, s, w) and tuple(h0.shape) == (bsz, w),
        f"b {tuple(b.shape)} / h0 {tuple(h0.shape)} do not match a {tuple(a.shape)}")
    req(all(t.is_contiguous() for t in ins), "contiguous tensors")
    req(bsz * s * w > 0 and bsz <= 65535, f"B={bsz}, S={s}, W={w}")
    hs = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    fn = _build.kernel_fn("rglru_scan", "rglru_scan_launch",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(), h_last.data_ptr(),
                 bsz, s, w, torch.cuda.current_stream().cuda_stream)
    _build.check("rglru_scan", err)
    _build.count("rglru_scan")
    return hs, h_last
