"""Common model building blocks: norms, RoPE, attention, MLPs.

Plain functions on tensors, in the JAX package's layouts: activations
``(B, S, d)``, q ``(B, S, H, hd)``, k/v ``(B, S, KV, hd)``.  Where JAX asks
for ``preferred_element_type=float32`` the inputs are widened to float32
before the product: the products of bf16 values are exact in float32, so
only the order of the sums differs.

Every product of an activation with a weight goes through :func:`linear`,
and every norm through :func:`rms_norm` or :func:`layer_norm`.  Under
``kernel_impl="cuda"`` (``impl`` here) they run the row-invariant kernels
of ``kernels/gemm.py``, ``kernels/rms_norm.py`` and
``kernels/layer_norm.py``, whose rows do not depend on the batch around
them (the served-equals-one-shot contract); otherwise ``torch.matmul`` and
PyTorch's reductions.

Tensor parallelism over a mesh's "model" axis (``distributed/sharding.py``):
a model rank holds a slice of each sliced leaf and the blocks see it in
the leaves' shapes.  A column-parallel product takes the replicated input
through ``copy_to`` and the rank's column slice of the weight: its outputs
are the one-rank product's columns, since every ``gemm_rowinv`` route sums
an output in one K chain.  A row-parallel product takes the rank's K
slice and sums the ranks' partial products with ``reduce_from``, adding a
bias once, after the sum.  A vocab-parallel embedding (:func:`embed_rows`)
zeroes the rows the rank does not hold and sums over "model" (exact: one
rank adds a non-zero row); the head's logits stay sliced over the
vocabulary, with :func:`vocab_nll` and :func:`vocab_argmax` computing
across the slices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (MODEL, copy_to, model_mesh, model_offset,
                                               reduce_from)
from repro_torch.kernels.gemm import linear_plain
from repro_torch.kernels.layer_norm import layer_norm_plain
from repro_torch.kernels.rms_norm import rms_norm_plain

NEG_INF = -1e30


def impl_for(cfg, mode: str) -> str:
    """The ``impl`` of a block's products, norms and scans in ``mode``:
    ``cfg.kernel_impl``, except ``"train"``, which takes the reference
    computations.  The JAX package trains on ``jnp`` everywhere outside
    attention (its Pallas scans have no VJP), and the port's row-invariant
    kernels have no backward; attention dispatches on ``cfg.kernel_impl``
    in every mode (``flash_attention``'s autograd Function under grad)."""
    return "reference" if mode == "train" else cfg.kernel_impl


def rms_norm(x, weight, eps: float, impl: str = "reference"):
    """Normalize in float32, cast back to x's dtype, *then* scale.
    ``impl="cuda"``: the row-invariant kernel (its plain version for CPU
    tensors)."""
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.rms_norm(x, weight, eps)
    return rms_norm_plain(x, weight, eps)


def layer_norm(x, weight, bias, eps: float, impl: str = "reference"):
    """LayerNorm with bias: mean and centred variance in float32, the
    normalized row cast back to x's dtype, *then* scaled and shifted.
    ``impl="cuda"``: the row-invariant kernel (its plain version for CPU
    tensors)."""
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.layer_norm(x, weight, bias, eps)
    return layer_norm_plain(x, weight, bias, eps)


def linear(x, w, impl: str = "reference", bias=None):
    """``x @ w (+ bias)``; a 3-D ``w`` (nb, K, N) is block-diagonal, x
    (..., nb, K).  ``impl="cuda"``: the row-invariant GEMM (its plain
    version for CPU tensors); otherwise ``torch.matmul``."""
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.linear(x, w, bias)
    return linear_plain(x, w, bias)


def sliced(local: int, whole: int):
    """The model mesh when a dim of ``whole`` is held as ``local`` on this
    rank (sliced over "model"), None where the rank holds it whole."""
    if local == whole:
        return None
    mesh = model_mesh()
    if mesh is None or local * mesh.shape["model"] != whole:
        raise ValueError(f"a dim of {whole} held as {local} needs a model axis of "
                         f"{whole // max(local, 1)} ranks")
    return mesh


def row_parallel(x, w, impl: str, mesh, bias=None):
    """``x @ w (+ bias)`` where ``x`` and ``w`` hold this model rank's K
    slice (``mesh`` None: whole): the ranks' partial products summed over
    "model", then the bias, once."""
    if mesh is None:
        return linear(x, w, impl, bias)
    y = reduce_from(linear(x, w, impl), mesh, MODEL)
    return y if bias is None else y + bias


def embed_rows(table, tokens, vocab: int, dtype):
    """``table[tokens]`` in ``dtype`` from a table (vocab, d) that this
    model rank may hold a row slice of: the rows it does not hold are
    zero, and the ranks' rows are summed over "model" (exactly: one rank
    adds each non-zero row)."""
    mesh = sliced(table.shape[0], vocab)
    if mesh is None:
        return table[tokens.long()].to(dtype)
    n = table.shape[0]
    loc = tokens.long() - model_offset(n, mesh)
    inside = (loc >= 0) & (loc < n)
    rows = table[torch.clamp(loc, 0, n - 1)].to(dtype)
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=dtype, device=rows.device))
    return reduce_from(rows, mesh, MODEL)


def vocab_nll(logits, labels, mask, vocab: int):
    """The summed negative log-likelihood of ``labels`` under float32
    ``logits`` (B, S, V), masked; ``logits`` may be this model rank's slice
    of the vocabulary, and then the log-softmax runs across the slices
    (the max and the sum of exponentials over "model", the label's logit
    from the rank that holds it) and no rank holds a whole row."""
    mesh = sliced(logits.shape[-1], vocab)
    if mesh is None:
        lp = torch.log_softmax(logits, dim=-1)
        return -torch.sum(lp.gather(-1, labels[..., None])[..., 0] * mask)
    n = logits.shape[-1]
    m = mesh.all_reduce(logits.detach().amax(dim=-1, keepdim=True), MODEL, "max")
    sumexp = reduce_from(torch.exp(logits - m).sum(dim=-1), mesh, MODEL)
    loc = labels.long() - model_offset(n, mesh)
    inside = (loc >= 0) & (loc < n)
    tgt = logits.gather(-1, torch.clamp(loc, 0, n - 1)[..., None])[..., 0]
    tgt = reduce_from(torch.where(inside, tgt, 0.0), mesh, MODEL)
    return -torch.sum((tgt - m[..., 0] - torch.log(sumexp)) * mask)


def vocab_argmax(logits, vocab: int):
    """``argmax`` over the last dim of ``logits``, which may be this model
    rank's slice of the vocabulary: each rank's greatest logit and its
    first index, then the greatest value over "model" with the lowest
    global index among equal ones -- ``torch.argmax`` of the whole row."""
    idx = logits.argmax(dim=-1)
    mesh = sliced(logits.shape[-1], vocab)
    if mesh is None:
        return idx
    best = logits.gather(-1, idx[..., None])[..., 0]
    top = mesh.all_reduce(best.clone(), MODEL, "max")
    gidx = idx + model_offset(logits.shape[-1], mesh)
    far = torch.full_like(gidx, -(1 << 62))
    return -mesh.all_reduce(torch.where(best == top, -gidx, far), MODEL, "max")


# ---------------------------------------------------------------- RoPE ----


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int.  Split-half rotation in
    float32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------- attention ----


def repeat_kv(k, n_rep: int):
    """(B, S, kv, hd) -> (B, S, kv*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def _position_mask(sq, sk, q_offset, causal, window, device):
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def naive_attention(q, k, v, *, causal: bool, window: int = 0, q_offset=0):
    """Reference O(S^2)-memory attention. q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd).

    ``q_offset`` is the absolute position of q[0] relative to k[0]."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    k = repeat_kv(k, h // kv)
    v = repeat_kv(v, h // kv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    mask = _position_mask(sq, sk, q_offset, causal, window, q.device)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """Online-softmax attention in plain torch: O(S) memory, a loop over KV
    chunks carrying the running (max, sum, acc) for each q chunk."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    scale = hd ** -0.5
    out = torch.empty_like(q)
    for q0 in range(0, sq, q_chunk):
        qblk = q[:, q0:q0 + q_chunk]
        qc = qblk.shape[1]
        qg = qblk.reshape(b, qc, kv, n_rep, hd).float()
        m = torch.full((b, h, qc), float("-inf"), device=q.device)
        l = torch.zeros((b, h, qc), device=q.device)
        acc = torch.zeros((b, h, qc, hd), device=q.device)
        for k0 in range(0, sk, kv_chunk):
            kblk = k[:, k0:k0 + kv_chunk]
            vblk = v[:, k0:k0 + kv_chunk]
            kc = kblk.shape[1]
            # GQA via a grouped-head einsum; head order h = g * n_rep + r.
            s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kblk.float())
            s = s.reshape(b, h, qc, kc) * scale
            msk = _position_mask(qc, kc, q0 + q_offset - k0, causal, window, q.device)
            s = s.masked_fill(~msk, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pg = p.to(q.dtype).reshape(b, kv, n_rep, qc, kc)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", pg, vblk)
            acc = acc * alpha[..., None] + pv.reshape(b, h, qc, hd).float()
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + qc] = o.transpose(1, 2).to(q.dtype)
    return out


def attention(q, k, v, cfg, *, causal: bool = True, window: int = 0, q_offset=0):
    """Dispatch on cfg.kernel_impl; q (B,Sq,H,hd), k/v (B,Sk,KV,hd).

    ``"cuda"`` sends every Sq > 1 call to the ``flash_attention`` kernel
    (its plain version for CPU tensors); everything else is the JAX
    package's reference dispatch."""
    sq, sk = q.shape[1], k.shape[1]
    if cfg.kernel_impl == "cuda" and sq > 1:
        from repro_torch.kernels import ops as kops

        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    if sq == 1:
        # Decode: one query token — a dense row over the KV cache.
        return naive_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if not cfg.fused_attention and sq * sk <= 4096 * 4096:
        return naive_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if sq * sk <= 512 * 512:  # tiny shapes: chunking is pure overhead
        return naive_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return chunked_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                             q_chunk=min(1024, sq), kv_chunk=min(1024, sk))


# ---------------------------------------------------------------- scan ----


def assoc_scan(a, b):
    """Inclusive scan of the recurrence h_t = a_t h_{t-1} + b_t along dim 1,
    from h = 0: returns the cumulative (prod a, h) pairs, so that a start
    state h0 gives h_t = prod_a[t] * h0 + h[t].  The JAX package's
    ``lax.associative_scan`` with the same combine, written as a log-step
    (Hillis-Steele) scan: step k combines each position with the one k
    before it, log2(S) tensor passes instead of S."""
    k = 1
    while k < a.shape[1]:
        a, b = (torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1),
                torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1))
        k *= 2
    return a, b


# ----------------------------------------------------------------- MLP ----


# Each MLP takes ``d_ff``, the hidden width of its whole weights: a rank
# that holds a column slice of the first products and the row slice of the
# last computes its part, and the parts sum over "model".


def swiglu(x, w_gate, w_up, w_down, impl: str = "reference", d_ff: int = 0):
    mesh = sliced(w_gate.shape[-1], d_ff or w_gate.shape[-1])
    x = copy_to(x, mesh, MODEL)
    h = F.silu(linear(x, w_gate, impl)) * linear(x, w_up, impl)
    return row_parallel(h, w_down, impl, mesh)


def geglu(x, w_gate, w_up, w_down, impl: str = "reference", d_ff: int = 0):
    mesh = sliced(w_gate.shape[-1], d_ff or w_gate.shape[-1])
    x = copy_to(x, mesh, MODEL)
    h = F.gelu(linear(x, w_gate, impl), approximate="tanh") * linear(x, w_up, impl)
    return row_parallel(h, w_down, impl, mesh)


def gelu_mlp(x, w_in, b_in, w_out, b_out, impl: str = "reference", d_ff: int = 0):
    """Exact (erf) GELU between two biased products (whisper's MLP)."""
    mesh = sliced(w_in.shape[-1], d_ff or w_in.shape[-1])
    x = copy_to(x, mesh, MODEL)
    h = F.gelu(linear(x, w_in, impl, b_in), approximate="none")
    return row_parallel(h, w_out, impl, mesh, b_out)
