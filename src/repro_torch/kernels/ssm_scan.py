"""Mamba selective scan: the prefill recurrence of the ssm family.

Port of the JAX package's Pallas TPU kernel ``kernels/ssm_scan.py``
(``ssm_scan``, body ``_kernel``).  With dt already through softplus, per
time step and state element::

    h = exp(dt * A) * h + (dt * x) * B;   y = sum_n h * C

dt/x ``(B,S,di)``, B/C ``(B,S,N)``, A ``(di,N)``, h0 ``(B,di,N)``, all
float32; returns y ``(B,S,di)`` and h_last ``(B,di,N)`` in float32.

``ssm_scan`` launches the CUDA kernel (``csrc/ssm_scan.cu``) on CUDA tensors
and runs ``ssm_scan_plain``, the same recurrence as a loop over time in
PyTorch, on CPU tensors.  The kernel keeps each channel's N states in one
thread's registers over the whole sequence, so unlike the TPU kernel it
needs no divisibility of S by a chunk or of di by a block, and the model
(``models/mamba.py``) sends it every prefill of S > 1 under
``kernel_impl="cuda"``.  :func:`scan_plan` is its launch, in Python.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


MAX_STATE = 32                  # N: one thread holds a channel's states in registers
STATE_PADS = (4, 8, 16, 32)     # the kernel's instances: N rounded up to one of these
CHANNEL_BLOCKS = (128, 64, 32)  # channels (threads) of one block, largest first
SCAN_STEPS = 16                 # time steps of one stage (kSteps in the source)
SCAN_STAGES = 2                 # stages of the cp.async ring (kStages)
SM_COUNT = 132                  # H100 SXM; the wrapper passes the card's own count
SMEM_NO_OPT_IN = 48 * 1024      # dynamic shared bytes a launch takes without opting in


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


def scan_plan(b: int, s: int, di: int, n: int, dtype=torch.float32, *, aligned: bool = True,
              sms: int = SM_COUNT) -> dict:
    """The kernel's launch, as ``ssm_scan_launch`` takes it: ``n_pad`` (N
    rounded up to 4, 8, 16 or 32) names the kernel instance (``kernel``),
    which alone fixes a channel's arithmetic; ``channels`` per block is the
    largest of 128, 64 and 32 that still gives two blocks per SM, else 32;
    ``grid`` is (di blocks, B); ``steps`` per stage, ``stages`` and ``smem``
    (a block's dynamic shared bytes, within 48 KB) as in the source;
    ``vec_d`` and ``vec_n`` say whether dt/x and B/C/A/h move in 16-byte
    copies (di, resp. N, a multiple of 4 and, ``aligned``, every tensor on
    16 bytes).
    Only ``channels``, ``grid`` and ``blocks`` depend on B.  Raises
    ValueError on what the kernel does not take.  Pure: the CPU tests call
    it."""
    req = _build.require
    req(dtype == torch.float32, f"the scan takes float32 tensors, got {dtype}")
    req(0 < n <= MAX_STATE, f"N={n} outside 1..{MAX_STATE}")
    req(min(b, s, di) > 0 and b <= 65535, f"B={b}, S={s}, di={di}")
    n_pad = next(p for p in STATE_PADS if p >= n)
    cpb = next((c for c in CHANNEL_BLOCKS if b * -(-di // c) >= 2 * sms), CHANNEL_BLOCKS[-1])
    smem = 4 * SCAN_STAGES * 2 * SCAN_STEPS * (cpb + n_pad)
    req(smem <= SMEM_NO_OPT_IN, f"{smem} bytes of shared memory")
    grid = (-(-di // cpb), b)
    return dict(kernel=f"ssm_scan_kernel<{n_pad}>", n_pad=n_pad, channels=cpb, grid=grid,
                blocks=grid[0] * grid[1], steps=SCAN_STEPS, stages=SCAN_STAGES, smem=smem,
                vec_d=aligned and di % 4 == 0, vec_n=aligned and n % 4 == 0)


def ssm_scan(dt, x, b_mat, c_mat, a, h0):
    """dt/x: (B,S,di); b_mat/c_mat: (B,S,N); a: (di,N); h0: (B,di,N); all
    float32.  Returns (y (B,S,di), h_last (B,di,N)) in float32.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`ssm_scan_plain`."""
    _build.refuse_grad("ssm_scan", dt, x, b_mat, c_mat, a, h0)
    if dt.device.type == "cpu":
        return ssm_scan_plain(dt, x, b_mat, c_mat, a, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu tensors, got {dt.device}")
    return _ssm_scan_cuda(dt, x, b_mat, c_mat, a, h0)


def _ssm_scan_cuda(dt, x, b_mat, c_mat, a, h0):
    import ctypes

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
    plan = scan_plan(bsz, s, di, n, dt.dtype, aligned=all(t.data_ptr() % 16 == 0 for t in ins),
                     sms=torch.cuda.get_device_properties(dt.device).multi_processor_count)
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((bsz, di, n), dtype=torch.float32, device=dt.device)
    fn = _build.kernel_fn("ssm_scan", "ssm_scan_launch",
                          [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with torch.cuda.device(dt.device):
        err = fn(dt.data_ptr(), x.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), a.data_ptr(),
                 h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), bsz, s, di, n,
                 plan["channels"], int(plan["vec_d"]), int(plan["vec_n"]),
                 torch.cuda.current_stream().cuda_stream)
    _build.check("ssm_scan", err)
    _build.count("ssm_scan")
    return y, h_last
