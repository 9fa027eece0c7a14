"""Plain dense oracles for the ported kernels (ground truth for tests)."""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """O(S^2) reference attention. q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    if n_rep > 1:
        k = k[:, :, :, None, :].expand(b, sk, kv, n_rep, hd).reshape(b, sk, h, hd)
        v = v[:, :, :, None, :].expand(b, sk, kv, n_rep, hd).reshape(b, sk, h, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_decode_ref(q, k, v, kpos, pos, *, window: int = 0):
    """Dense ragged-decode oracle. q: (B,Sq,H,hd); k/v: (B,S,KV,hd) (any
    storage dtype); kpos: (B,S) recorded positions (−1 = empty); pos: (B,)
    per-slot query positions.  Row j of slot b attends every key with
    ``0 <= kpos <= pos[b] + j`` (window-masked when set); a row with no
    valid keys returns zeros.

    The same definition as serving's dense fallback
    (``models.attention._ragged_dense``), as in the JAX package."""
    from repro_torch.models.attention import _ragged_dense

    return _ragged_dense(q, k, v, kpos, pos.to(torch.int32), window=window)


def ssm_scan_ref(dt, x, b_mat, c_mat, a, h0):
    """Mamba selective scan, sequential ground truth.

    dt/x: (B,S,di) [dt already softplus'd]; b_mat/c_mat: (B,S,N);
    a: (di,N) negative; h0: (B,di,N) fp32.  Returns (y (B,S,di) f32, h_last).
    """
    dtf, xf, bf, cf = (t.float() for t in (dt, x, b_mat, c_mat))
    h = h0.float()
    ys = []
    for t in range(dtf.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * a)  # (B,di,N)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, dim=1), h


def rglru_scan_ref(a, b, h0):
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t (all fp32).

    a/b: (B,S,W); h0: (B,W). Returns (hs (B,S,W), h_last)."""
    af, bf = a.float(), b.float()
    h = h0.float()
    hs = []
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
