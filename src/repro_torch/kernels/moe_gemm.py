"""Grouped, row-invariant expert products of the MoE family: the capacity
buffer's three expert einsums (``ecd,edf->ecf`` for gate and up,
``ecf,efd->ecd`` for down) without the capacity rows and experts a call
does not fill.

The JAX package computes them with plain ``jnp`` einsums over every expert
and every capacity row (``src/repro/models/moe.py:112-117``); no Pallas
kernel corresponds to this one.  The einsum as written streams every
expert's weights: arctic-480b's three leaves hold 26.8 GB a layer, yet a
decode step of 8 tokens at top-2 reaches at most 16 of its 128 experts.
An empty capacity row gives a zero product, so skipping it and writing
its zeros computes the same function.  The zeros are needed: the combine
(``models/moe.py``) reads slot C - 1 for a dropped assignment and
multiplies it by a zero weight, so that row must not hold a NaN.

The CUDA kernel (``csrc/moe_gemm.cu``) takes ``count`` (E,) -- the filled
rows of each expert -- and, for gate and up, a row map ``rows`` (E, C):
slot (e, c) holds token row ``rows[e, c]`` of ``x`` (-1: a zero row), so
the (E, C, d) buffer is never materialized.  Both live on the device and
the kernel reads them there: no host sync, so a graph captures it.  Each
output element is one chain of ``wgmma`` k16 products in ascending k,
fixed by K alone (:func:`plan`'s ``chain``, the chain of ``gemm_rowinv``),
so a routed row gives the same bits whatever ``count``, C, the other rows
of its tile or the other experts.

How it runs (:func:`plan`, a pure function of the shape and the card's
SM count, never of the counts, which live on the card; the launch takes
its tile, stages and blocks, and the kernel refuses a tile it was not
built for):

- One persistent wave of blocks, one an SM at most, walks the filled
  tiles: each block prefix-sums ``ceil(count[e] / 64)`` row tiles over the
  experts and takes tiles ``b, b + blocks, ...`` in (expert, row tile,
  column tile) order, the column tile fastest, so the blocks running at
  once read one expert's A from L2 while its weight columns stream once.
  Rows no tile covers -- every row of an empty expert, row tiles past an
  expert's filled ones -- are written as zeros by a store loop in the
  same launch.
- A producer warpgroup fills a ring of 5 stages of 64 k (40 KB each)
  behind mbarriers and never waits on its own loads.  The weights come by
  TMA.  Down's A is the buffer in memory: TMA over (K, C, E), a box of C
  rows rounded up to 8 (at most 64), so decode moves its 8 rows.  Gate
  and up's A is gathered through ``rows``, which TMA cannot do: 16-byte
  ``cp.async`` copies that complete on the stage's barrier.  The consumer
  stages each output part in shared memory and sends it by TMA stores
  while it starts the next tile.
- Each stage holds two weight parts of 128 columns: gate and up at the
  same columns, or two neighbouring column blocks of down, so a tile is
  64 x 128 fused and 64 x 256 for down, and A is read once per 128 or 256
  output columns.  One tile serves every C: at every C the call is bound
  by the filled experts' weight bytes, and the tensor work stays well
  under them.

One tile, because a narrower decode tile (64 x 64 fused, 64 x 128 down,
two blocks an SM), measured beside it on the H100 (NVIDIA H100 80GB
HBM3, 700 W; ``chip_smoke.py``'s ``[moe kernel]`` cases), was faster in
no case at C 8 beyond the run-to-run spread (within 2% on arctic-480b's
and kimi-k2-1t-a32b's four decode cases) and 11% slower on gate/up from
C 16 on.

``moe_gemm(x, w, count, rows, w_up)`` launches the kernel on CUDA tensors
(or raises) and runs :func:`moe_gemm_plain` on CPU tensors.  The model
launches it twice a layer: gate and up fused (``w_up`` given: the output
is ``silu(x @ w) * (x @ w_up)``), then down on that output.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build


MAX_E = 512    # experts whose counts a block stages (csrc/moe_gemm.cu kMaxE)
BM = BK = 64   # rows and k of a tile
PART = 128     # columns of one weight part: a stage holds two
STAGES = 5     # ring stages of 40 KB


class Plan(NamedTuple):
    """How one call launches: its ``tile`` (BM, BN, BK: BN the output
    columns of a tile, one weight part fused and two for down), ring
    ``stages`` and ``blocks`` (one wave, at most one an SM and at most the
    tiles a call could fill) -- the launch's arguments -- and ``chain``:
    (step, steps, splits), one chain of ``steps`` k16 tensor-core products
    in ascending k, no split, fixed by K alone."""
    tile: tuple
    stages: int
    blocks: int
    chain: tuple

    def describe(self) -> str:
        step, steps, splits = self.chain
        bm, bn, bk = self.tile
        return (f"{bm}x{bn}x{bk}, {self.stages} stages, {self.blocks} blocks, "
                f"chain {steps} x {step} ascending, {splits} split")


@functools.lru_cache(maxsize=4096)
def plan(E: int, C: int, K: int, N: int, fused: bool, sms: int) -> Plan:
    """The launch plan of a call over E experts of capacity C, (K, N)
    weights, gate and up ``fused`` or down, on a card of ``sms`` SMs.  The
    tile follows ``fused`` alone, the chain K alone, the grid the shape
    and ``sms``.  Pure: the CPU tests call it."""
    bn = PART if fused else 2 * PART
    most = E * -(-C // BM) * -(-N // bn)
    return Plan((BM, bn, BK), STAGES, min(sms, most), ("k16", -(-K // 16), 1))


@functools.lru_cache(maxsize=64)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def capacity_buffer(x, count, rows=None):
    """The (E, C, K) capacity buffer the products read: ``x`` itself when
    ``rows`` is None, else token row ``rows[e, c]`` of ``x`` (T, K) at
    slot (e, c), zeros where ``rows`` is negative; zeros from row
    ``count[e]`` on."""
    if rows is not None:
        buf = x[rows.clamp(min=0).long()]
        buf = torch.where((rows >= 0)[..., None], buf, x.new_zeros(()))
    else:
        buf = x
    c = torch.arange(buf.shape[1], device=buf.device)
    live = c[None, :] < count[:, None]
    return torch.where(live[..., None], buf, buf.new_zeros(()))


def moe_gemm_plain(x, w, count, rows=None, w_up=None):
    """The kernel's function in PyTorch: the reference's dense einsum over
    the whole capacity buffer (:func:`capacity_buffer`), fused with
    ``silu(. @ w) * (. @ w_up)`` when ``w_up`` is given.  The CPU path, and
    the kernel's oracle on the card."""
    buf = capacity_buffer(x, count, rows)
    y = torch.einsum("eck,ekn->ecn", buf, w)
    if w_up is None:
        return y
    return F.silu(y) * torch.einsum("eck,ekn->ecn", buf, w_up)


def moe_gemm(x, w, count, rows=None, w_up=None):
    """w, w_up: (E, K, N), the JAX tree's expert leaves; count: (E,) int32
    filled rows per expert; rows: (E, C) int32 token row of each slot of
    ``x`` (T, K), or None with ``x`` the (E, C, K) buffer itself.  Returns
    (E, C, N) in x's dtype.

    CUDA tensors launch the kernel (bfloat16 only; or raise); CPU tensors
    take :func:`moe_gemm_plain`."""
    _build.refuse_grad("moe_gemm", x, w, w_up)
    if x.device.type == "cpu":
        return moe_gemm_plain(x, w, count, rows, w_up)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm runs on cuda or cpu tensors, got {x.device}")
    return _moe_gemm_cuda(x, w, count, rows, w_up)


def _moe_gemm_cuda(x, w, count, rows, w_up):
    import ctypes

    if x.dtype != torch.bfloat16 or w.dtype != x.dtype or (w_up is not None
                                                           and w_up.dtype != x.dtype):
        raise TypeError(f"moe_gemm takes bfloat16 x and weights, got {x.dtype}, {w.dtype}")
    tensors = [t for t in (x, w, count, rows, w_up) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all tensors on one device")
    e, k, n = w.shape
    if w_up is not None and tuple(w_up.shape) != (e, k, n):
        raise ValueError(f"w_up {tuple(w_up.shape)} != w {tuple(w.shape)}")
    if e > MAX_E:
        raise ValueError(f"moe_gemm takes at most {MAX_E} experts, got {e}")
    if count.dtype != torch.int32 or tuple(count.shape) != (e,):
        raise ValueError(f"count must be int32 ({e},), got {count.dtype} {tuple(count.shape)}")
    if rows is not None:
        if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[0] != e:
            raise ValueError(f"rows must be int32 ({e}, C), got {rows.dtype} "
                             f"{tuple(rows.shape)}")
        if x.dim() != 2 or x.shape[1] != k:
            raise ValueError(f"x {tuple(x.shape)} must be token rows (T, {k})")
        c = rows.shape[1]
    else:
        if x.dim() != 3 or tuple(x.shape) != (e, x.shape[1], k):
            raise ValueError(f"x {tuple(x.shape)} must be the buffer ({e}, C, {k})")
        c = x.shape[1]
    xr = x.reshape(-1, k)
    if xr.stride(-1) != 1 or (xr.shape[0] > 1 and xr.stride(0) % 8):
        xr = xr.contiguous()
    lda = xr.stride(0) if xr.shape[0] > 1 else k
    ws = [t.contiguous() for t in (w, w_up) if t is not None]
    if k % 8 or n % 8 or any(t.data_ptr() % 16 for t in [xr] + ws):
        raise ValueError(f"moe_gemm needs K, N multiples of 8 and 16-byte aligned operands "
                         f"(K {k}, N {n})")
    cnt = count.contiguous()
    rmap = None if rows is None else rows.contiguous()
    y = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    p = plan(e, c, k, n, w_up is not None, _sm_count(x.device.index))
    fn = _build.kernel_fn("moe_gemm", "moe_gemm_launch",
                          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                          + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with _build.on_device(x.device) as stream:
        err = fn(xr.data_ptr(), 0 if rmap is None else rmap.data_ptr(), cnt.data_ptr(),
                 ws[0].data_ptr(), ws[1].data_ptr() if len(ws) > 1 else 0, y.data_ptr(),
                 e, c, k, n, lda, p.tile[1], p.stages, p.blocks, stream)
    _build.check("moe_gemm", err)
    _build.count("moe_gemm")
    return y
