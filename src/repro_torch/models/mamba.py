"""Mamba-1 selective SSM block (falcon-mamba-7b).

Prefill runs the selective scan over the whole prompt; decode carries
(conv_state, ssm_state), O(1) per token.  ``ssm_forward`` takes:

- S == 1: the elementwise decode step, no kernel;
- ``kernel_impl == "cuda"``, any other S: the ``ssm_scan`` kernel, which
  needs no divisibility of S (the TPU kernel needed S % 256 == 0);
- ``"reference"`` with S % 256 == 0: the chunked scan, a log-step scan
  within each 256-step chunk;
- ``"reference"``, any other S: ``ssm_scan_plain``, a loop over time.

Training (``mode="train"``) has no cache: the scan starts from zeros and
takes the reference's scans above (the JAX package's Pallas scan has no
VJP), as do the products and the norm.  The cache is written in place (the
JAX package returned a new one).

Tensor parallelism over "model": a rank holds ``di/par`` of the channels
of ``conv_w``, ``conv_b``, ``dt_proj``, ``dt_bias``, ``A_log``, ``D`` and
both caches, ``x_proj`` and ``out_proj`` are row-parallel, and the scan
runs on the rank's channels, each channel's bits its own.  ``in_proj`` is
column-parallel in a layout of the port's own (:data:`PARTS`): the rank's
x channels then its z channels, one product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import MODEL, copy_to
from repro_torch.kernels.ssm_scan import ssm_scan_plain
from repro_torch.models import layers as L
from repro_torch.models.params import Spec

CHUNK = 256

# The leaves a model rank holds in a layout of its own (the blocks of
# ``distributed.sharding.Parts``), not as the reference's contiguous
# slice, with the reason.
PARTS = {
    "in_proj": (2, "the reference slices the concatenated x|z columns (d, 2 di) contiguously, "
                   "so at par 2 one rank would hold all of x and the other all of z, while "
                   "conv_w, x_proj and the rest slice di: each rank holds its di/par columns "
                   "of x then its di/par columns of z, and the gather puts the blocks back "
                   "in the reference's order"),
}


def dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    dt_rank = -(-cfg.d_model // 16)  # ceil(d_model/16)
    return di, dt_rank, cfg.ssm_state


def mamba_block_spec(cfg, par: int = 1) -> dict:
    d = cfg.d_model
    di, R, N = dims(cfg)
    m = "model" if par > 1 and di % par == 0 else None
    return {
        "norm": Spec((d,), "ones", pspec=(None,)),
        "in_proj": Spec((d, 2 * di), pspec=(None, m)),
        "conv_w": Spec((di, cfg.ssm_conv), "small_normal", 0.1, pspec=(m, None)),
        "conv_b": Spec((di,), "zeros", pspec=(m,)),
        "x_proj": Spec((di, R + 2 * N), pspec=(m, None)),
        "dt_proj": Spec((R, di), pspec=(None, m)),
        "dt_bias": Spec((di,), "ones", pspec=(m,)),
        "A_log": Spec((di, N), "small_normal", 0.5, pspec=(m, None)),
        "D": Spec((di,), "ones", pspec=(m,)),
        "out_proj": Spec((di, d), pspec=(m, None)),
    }


def ssm_cache_spec(cfg, batch: int, par: int = 1) -> dict:
    di, _, N = dims(cfg)
    m = "model" if par > 1 and di % par == 0 else None
    return {
        "conv": Spec((batch, cfg.ssm_conv - 1, di), "zeros", pspec=("batch", None, m)),
        "ssm": Spec((batch, di, N), "zeros", pspec=("batch", m, None)),
    }


def _causal_conv(x, w, b, ck: int):
    """Depthwise causal conv along S via shift-accumulate. x: (B,S,di);
    ``w[:, -1]`` weighs the current token."""
    out = x * w[:, -1]
    for i in range(1, ck):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        out = out + shifted * w[:, ck - 1 - i]
    return out + b


def chunked_scan(dt, xf, Bf, Cf, A, h0):
    """The reference's scan where S is a multiple of ``CHUNK``: within
    each chunk a log-step scan (``layers.assoc_scan``) of its (B, CHUNK,
    di, N) state, carried from chunk to chunk.  float32 dt, x (B, S, di),
    B, C (B, S, N), A (di, N), h0 (B, di, N); returns (y without the D
    term, h_last)."""
    s = dt.shape[1]
    h, ys = h0, []
    for c0 in range(0, s, CHUNK):
        dt_c, x_c = dt[:, c0:c0 + CHUNK], xf[:, c0:c0 + CHUNK]
        dA = torch.exp(dt_c[..., None] * A)  # (B,Ck,di,N)
        dBx = (dt_c * x_c)[..., None] * Bf[:, c0:c0 + CHUNK, None, :]
        a_s, b_s = L.assoc_scan(dA, dBx)
        del dA, dBx
        hs = a_s * h[:, None] + b_s  # (B,Ck,di,N)
        del a_s, b_s
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, Cf[:, c0:c0 + CHUNK]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def ssm_forward(p, x, cfg, h0=None, impl=None):
    """x: (B, S, di) post-conv activations. Returns (y, h_last).

    The (B, S, di, N) state tensor is never materialized beyond one
    256-step chunk."""
    b, s, di = x.shape
    _, R, N = dims(cfg)
    impl = impl or cfg.kernel_impl
    # Row-parallel on the rank's channels; dt, B and C whole on every rank.
    mesh = L.sliced(di, dims(cfg)[0])
    xdb = copy_to(L.row_parallel(x, p["x_proj"], impl, mesh), mesh, MODEL)  # (B,S,R+2N)
    dt, B_ssm, C_ssm = torch.split(xdb, [R, N, N], dim=-1)
    dt = F.softplus(L.linear(dt, p["dt_proj"], impl, p["dt_bias"])).float()  # (B,S,di)
    A = -torch.exp(p["A_log"].float())  # (di, N)
    xf = x.float()
    Bf, Cf = B_ssm.float(), C_ssm.float()
    if h0 is None:
        h0 = torch.zeros((b, di, N), dtype=torch.float32, device=x.device)

    if s == 1:
        h_last = (torch.exp(dt[:, 0, :, None] * A) * h0
                  + (dt[:, 0] * xf[:, 0])[..., None] * Bf[:, 0, None, :])
        y = torch.einsum("bdn,bn->bd", h_last, Cf[:, 0])[:, None]
    elif impl == "cuda":
        from repro_torch.kernels import ops as kops

        y, h_last = kops.ssm_scan(dt, xf.contiguous(), Bf.contiguous(), Cf.contiguous(), A,
                                  h0.contiguous())
    elif s % CHUNK == 0:
        y, h_last = chunked_scan(dt, xf, Bf, Cf, A, h0)
    else:
        y, h_last = ssm_scan_plain(dt, xf, Bf, Cf, A, h0)
    y = y + xf * p["D"]
    return y.to(x.dtype), h_last


def mamba_block_apply(p, x, positions, cfg, *, mode, cache, pos=None):
    """One Mamba layer; ``cache`` ({conv, ssm}) is updated in place.  In
    ``mode="train"`` (no cache) returns (x, 0.0), no aux loss."""
    del positions, pos
    impl = L.impl_for(cfg, mode)
    h = L.rms_norm(x, p["norm"], cfg.norm_eps, impl)
    mesh = L.sliced(p["conv_b"].shape[0], dims(cfg)[0])
    # in_proj: the rank's x channels then its z channels (PARTS).
    x_in, z = L.linear(copy_to(h, mesh, MODEL), p["in_proj"], impl).chunk(2, dim=-1)
    if mode == "train":
        xc = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"], cfg.ssm_conv))
        y, _ = ssm_forward(p, xc, cfg, impl=impl)
        return x + L.row_parallel(y * F.silu(z), p["out_proj"], impl, mesh), 0.0
    h0 = cache["ssm"].float()
    if mode == "decode":
        # Roll the conv state: a one-step conv, then one scan step.
        conv_in = torch.cat([cache["conv"].to(x_in.dtype), x_in], dim=1)  # (B, ck, di)
        xc = torch.einsum("bkd,dk->bd", conv_in, p["conv_w"])[:, None] + p["conv_b"]
        y, h_last = ssm_forward(p, F.silu(xc), cfg, h0=h0)
        cache["conv"].copy_(conv_in[:, 1:])
    elif mode == "prefill":
        xc = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"], cfg.ssm_conv))
        y, h_last = ssm_forward(p, xc, cfg, h0=h0)
        # The conv's zero padding stays in the state of a prompt shorter
        # than the window.
        cache["conv"].copy_(F.pad(x_in, (0, 0, cfg.ssm_conv - 1, 0))[:, -(cfg.ssm_conv - 1):])
    else:
        raise ValueError(f"mode {mode!r} is not train, prefill or decode")
    cache["ssm"].copy_(h_last)
    out = L.row_parallel(y * F.silu(z), p["out_proj"], impl, mesh)
    return x + out, cache
