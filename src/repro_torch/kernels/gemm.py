"""Row-invariant matrix product: every product of the models whose rows
could depend on the batch (projections, MLPs, the head, recurrentgemma's
block-diagonal gates).

The JAX package computes these products with plain ``jnp`` einsums; no
Pallas kernel corresponds to this one.  It exists for the contract that a
served stream equals one-shot generate of its request alone, bitwise: the
CUDA kernel (``csrc/gemm_rowinv.cu``) sums every output element over K in
one chain of ``wgmma`` k16 products in ascending k, fixed by K alone, so a
row of ``x`` gives the same bits at any M and through any route.

:func:`plan` is the launch plan, a pure function of the shape: the route
and its tile -- ``wide`` (128 x 256 tiles of two consumer warpgroups fed
by a TMA ring: prefill), ``narrow`` (64 x 32: x_proj's N 288 at M > 64),
``gemv`` and ``head`` (64 x 32 and 64 x 128: decode, the vocabularies on
the wider one), ``plain`` (the narrow tile filled by plain loads, for
operands TMA cannot read), ``f32`` (FMAs) -- and the K chain, which every
bf16 route shares.

``linear(x, w, bias)`` launches the kernel on CUDA tensors (or raises) and
runs ``linear_plain``, ``torch.matmul`` plus the bias, on CPU tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build


NUM_SMS = 132  # H100 SXM
HEAD_N = 32768  # decode products at least this wide take the 128-wide tile
# Route codes of csrc/gemm_rowinv.cu, and each route's (BM, BN, BK) tile
# and ring stages.
ROUTES = {"f32": 0, "wide": 1, "narrow": 2, "plain": 3, "gemv": 4, "head": 5}
TILES = {"f32": ((64, 64, 16), 1), "wide": ((128, 256, 64), 4),
         "narrow": ((64, 32, 64), 5), "plain": ((64, 32, 64), 5),
         "gemv": ((64, 32, 64), 8), "head": ((64, 128, 64), 6)}


class Plan(NamedTuple):
    """How one product launches.  ``route`` and its ``tile`` (BM, BN, BK)
    and ``stages`` may follow M; ``chain`` -- (step, steps, splits): one
    chain of ``steps`` k16 tensor-core products in ascending k, or of K
    FMAs in float32, with no split over K -- is fixed by K and the dtype
    alone."""
    route: str
    tile: tuple
    stages: int
    chain: tuple

    def describe(self) -> str:
        step, steps, splits = self.chain
        bm, bn, bk = self.tile
        return (f"{self.route} {bm}x{bn}x{bk}, {self.stages} stages, chain {steps} x {step} "
                f"ascending, {splits} split")


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, wt: int, aligned: bool, *, batch: int = 1,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The launch plan of an (m, k) x (k, n) product (``batch`` of them;
    ``wt``: the weight stored transposed; ``aligned``: TMA can read the
    operands, ``operands(...)["tma"]``).  bf16, TMA-fed routes: at M > 64,
    ``wide`` when 128 x 256 tiles fill the card's SMs at least once, else
    ``narrow`` (64 x 32 tiles, three blocks an SM: x_proj's N 288); at
    M <= 64 (decode), ``head`` (64 x 128) from N = ``HEAD_N`` on, else
    ``gemv`` (64 x 32, an 8-stage ring).  ``plain`` where TMA cannot read.
    ``wt`` picks the instance, not the plan.  Pure: the CPU tests call it."""
    if dtype == torch.float32:
        route, chain = "f32", ("fma", k, 1)
    elif dtype != torch.bfloat16:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    else:
        chain = ("k16", -(-k // 16), 1)
        if not aligned:
            route = "plain"
        elif m > 64:
            route = "wide" if -(-m // 128) * -(-n // 256) * batch >= NUM_SMS else "narrow"
        else:
            route = "head" if n >= HEAD_N else "gemv"
    tile, stages = TILES[route]
    return Plan(route, tile, stages, chain)


def linear_plain(x, w, bias=None):
    """The kernel's function in PyTorch: ``x @ w`` for a 2-D ``w`` (K, N);
    for a 3-D block-diagonal ``w`` (nb, K, N), ``x`` (..., nb, K) times each
    block.  The bias is added to the product in its dtype, as the models
    add it.  The CPU path, and the kernel's oracle on the card."""
    y = x @ w if w.dim() == 2 else torch.einsum("...nk,nkv->...nv", x, w)
    return y if bias is None else y + bias


def linear(x, w, bias=None, *, route=None):
    """x: (..., K) and w: (K, N), or x: (..., nb, K) and w: (nb, K, N) (one
    product per block, one launch); bias: (N,) or (nb, N).  One dtype,
    float32 or bfloat16.  Returns (..., N) or (..., nb, N) in x's dtype.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`linear_plain`.  ``route`` forces one of :data:`ROUTES` in place
    of :func:`plan`'s (the card's check that every route gives the same
    bits); the kernel refuses a route the operands cannot take."""
    _build.refuse_grad("gemm_rowinv", x, w, bias)
    if x.device.type == "cpu":
        return linear_plain(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"linear runs on cuda or cpu tensors, got {x.device}")
    return _linear_cuda(x, w, bias, route)


def operands(x, w, bias=None) -> dict:
    """How ``linear`` hands x, w and bias to the kernel: the 2-D views
    and the strides it passes (``x2``, ``w2``, ``m``, ``n``, ``k``, ``lda``,
    ``ldw``, ``ldy``, ``batch``, ``sx``, ``sw``, ``sb``, ``sy``, ``wt``,
    ``out_shape``).  Views where the layout allows it, copies otherwise.
    ``wt`` = 1 when w is stored transposed, (N, K) row-major (a tied head's
    ``embed.T``).  ``tma``: TMA can read x and w (16-byte aligned bases,
    row and batch strides, K and N multiples of 8), as the kernel's
    ``tma_ok`` decides.  Pure: the CPU tests call it."""
    if w.dim() == 2:
        k, n = w.shape
        if x.shape[-1] != k:
            raise ValueError(f"x {tuple(x.shape)} does not match w {tuple(w.shape)}")
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
        if x.dim() < 2 or tuple(x.shape[-2:]) != (nb, k):
            raise ValueError(f"x {tuple(x.shape)} does not match block weights "
                             f"{tuple(w.shape)}")
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
    if bias is not None and tuple(bias.shape) != blocks + (n,):
        raise ValueError(f"bias {tuple(bias.shape)} does not match the output's "
                         f"{blocks + (n,)}")
    tma = (x2.data_ptr() % 16 == 0 and w2.data_ptr() % 16 == 0 and lda % 8 == 0
           and ldw % 8 == 0 and (batch == 1 or (sx % 8 == 0 and sw % 8 == 0))
           and k % 8 == 0 and n % 8 == 0)
    return dict(x2=x2, w2=w2, m=m, n=n, k=k, lda=lda, ldw=ldw, ldy=ldy, batch=batch,
                sx=sx, sw=sw, sb=sb, sy=sy, wt=wt, tma=tma,
                out_shape=tuple(x.shape[:-1]) + (n,))


def maps_encoded() -> int:
    """TMA maps the kernel library has encoded so far (its cache's misses:
    each costs host time; a call whose operands' maps are cached encodes
    none).  Builds and loads the library on first use."""
    return _build.kernel_fn("gemm_rowinv", "gemm_rowinv_maps_encoded", [])()


def _linear_cuda(x, w, bias, route=None):
    import ctypes

    if w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("all tensors on one device")
    if x.dtype != w.dtype or (bias is not None and bias.dtype != x.dtype):
        raise ValueError(f"x, w and bias share one dtype (got {x.dtype}, {w.dtype}"
                         f"{'' if bias is None else ', ' + str(bias.dtype)})")
    code = _build.dtype_code(x)
    o = operands(x, w, bias)
    y = torch.empty(o["out_shape"], dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if o["k"] == 0:
        raise ValueError("K = 0")
    if route is None:
        route = plan(o["m"], o["n"], o["k"], o["wt"], o["tma"], batch=o["batch"],
                     dtype=x.dtype).route
    elif route not in ROUTES:
        raise ValueError(f"route {route!r} is none of {sorted(ROUTES)}")
    b = None if bias is None else bias.contiguous()
    fn = _build.kernel_fn("gemm_rowinv", "gemm_rowinv_launch",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                          + [ctypes.c_longlong] * 3 + [ctypes.c_int]
                          + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
                          + [ctypes.c_void_p])
    with _build.on_device(x.device) as stream:
        err = fn(o["x2"].data_ptr(), o["w2"].data_ptr(), 0 if b is None else b.data_ptr(),
                 y.data_ptr(), o["m"], o["n"], o["k"], o["lda"], o["ldw"], o["ldy"],
                 o["batch"], o["sx"], o["sw"], o["sb"], o["sy"], o["wt"], code,
                 ROUTES[route], stream)
    _build.check("gemm_rowinv", err)
    _build.count("gemm_rowinv")
    return y
