"""Port's flash_decode_paged (its plain version, on CPU tensors) vs the JAX
package's Pallas ``flash_decode_paged`` in interpret mode, on the cases of
tests/test_flash_decode.py (``test_paged_kernel_parity`` and
``test_paged_multirow_bit_identical_to_contiguous``): GQA ratios 1/2/4,
full and rolling-window caches in blocks, empty slots, multi-row decode.

Tolerance 2e-5 against the JAX kernel (float32; only the order of float32
sums differs).  Inside the port the paged path must be *bitwise* equal to
the contiguous plain path at ``block_k = bl`` on the gathered layout, a
batch-1 row must equal its batch row, and null-block table entries must be
no-ops."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ops import flash_decode_paged as jax_flash_decode_paged
from repro_torch.kernels.flash_decode import flash_decode_paged_plain, gather_pool
from repro_torch.kernels.ops import (
    flash_decode,
    flash_decode_paged,
    launch_counts,
    reset_launch_counts,
)

TOL = 2e-5


def ragged_cache(seed, b, s, kv, hd, pos, window):
    """Cache-as-stored with serve semantics (as tests/test_flash_decode.py):
    full caches record position t at slot t, rolling caches at t % s;
    unwritten slots keep pos -1 and garbage k/v."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, s, kv, hd), np.float32)
    v = rng.standard_normal((b, s, kv, hd), np.float32)
    kpos = np.full((b, s), -1, np.int32)
    for i, p in enumerate(pos):
        for t in range(max(0, p - s + 1), p + 1):
            kpos[i, t % s if window else t] = t
    return k, v, kpos


def as_pool(k, v, kpos, bl, seed=0):
    """Scatter a contiguous ragged cache into a block pool with a random
    physical permutation (as tests/test_flash_decode.py): pool k/v/kpos of
    (N, bl, ...) plus (B, nmax + 1) tables; blocks 0 (sink) and 1 (null,
    kpos −1) stay reserved, and the extra table column resolves to the
    null block."""
    b, s = kpos.shape
    nmax = s // bl
    rng = np.random.default_rng(seed)
    n = b * nmax + 2
    perm = rng.permutation(np.arange(2, n))
    tables = np.ones((b, nmax + 1), np.int32)
    kp = np.full((n, bl), -1, np.int32)
    kpool = np.zeros((n, bl) + k.shape[2:], k.dtype)
    vpool = np.zeros_like(kpool)
    for i in range(b):
        for t in range(nmax):
            ph = perm[i * nmax + t]
            tables[i, t] = ph
            kpool[ph] = k[i, t * bl:(t + 1) * bl]
            vpool[ph] = v[i, t * bl:(t + 1) * bl]
            kp[ph] = kpos[i, t * bl:(t + 1) * bl]
    return kpool, vpool, kp, tables


def jax_paged(q, kpool, vpool, kp, tables, pos, window):
    return np.asarray(jax_flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(kp),
        jnp.asarray(tables), jnp.asarray(pos, jnp.int32), window=window, interpret=True))


def t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("kv", [4, 2, 1])  # GQA ratios 1, 2, 4 (h = 4)
@pytest.mark.parametrize("window,s,bl,pos", [
    (0, 48, 16, (-1, 0, 15, 16, 17, 47)),
    (0, 32, 8, (5, 31)),
    (8, 16, 8, (-1, 3, 15, 40)),   # rolling-window ring in blocks
], ids=["full", "full-bl8", "window-ring"])
def test_paged_plain_matches_jax(kv, window, s, bl, pos):
    b, h, hd = len(pos), 4, 16
    q = np.random.default_rng(3).standard_normal((b, 1, h, hd), np.float32)
    k, v, kpos = ragged_cache(19, b, s, kv, hd, pos, window)
    kpool, vpool, kp, tables = as_pool(k, v, kpos, bl)
    posv = np.asarray(pos, np.int32)
    want = jax_paged(q, kpool, vpool, kp, tables, posv, window)
    tq, tk, tv, tkp, ttab, tpos = t(q, kpool, vpool, kp, tables, posv)
    got = flash_decode_paged(tq, tk, tv, tkp, ttab, tpos, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # Bitwise the contiguous plain path at block_k = bl, on the original
    # contiguous cache (the gather is an exact permutation and the extra
    # null-block column is an exact no-op).
    contig = flash_decode(tq, *t(k, v, kpos), tpos, window=window, block_k=bl)
    assert torch.equal(got, contig)
    for i, p in enumerate(pos):
        if p < 0:  # no valid keys: exact zeros
            assert not torch.any(got[i])
        one = flash_decode_paged(tq[i:i + 1], tk, tv, tkp, ttab[i:i + 1], tpos[i:i + 1],
                                 window=window)
        assert torch.equal(one[0], got[i])


@pytest.mark.parametrize("sq", [2, 4])
def test_paged_multirow_plain_matches_jax(sq):
    s, bl, h, kv, hd = 32, 8, 4, 2, 16
    pos = (0, 7, 32 - sq)
    b = len(pos)
    written = [min(p + sq - 1, s - 1) for p in pos]
    q = np.random.default_rng(17).standard_normal((b, sq, h, hd), np.float32)
    k, v, kpos = ragged_cache(37, b, s, kv, hd, written, 0)
    kpool, vpool, kp, tables = as_pool(k, v, kpos, bl)
    posv = np.asarray(pos, np.int32)
    want = jax_paged(q, kpool, vpool, kp, tables, posv, 0)
    tq, tk, tv, tkp, ttab, tpos = t(q, kpool, vpool, kp, tables, posv)
    got = flash_decode_paged(tq, tk, tv, tkp, ttab, tpos)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    assert torch.equal(got, flash_decode(tq, *t(k, v, kpos), tpos, block_k=bl))


def test_null_block_entries_are_no_ops():
    """Table entries past a slot's blocks that resolve to the null block
    (never written, kpos −1) change no bit, however many there are."""
    pos = (3, 20, 31)
    q = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 1, 4, 16), np.float32))
    k, v, kpos = ragged_cache(41, 3, 32, 2, 16, pos, 0)
    kpool, vpool, kp, tables = t(*as_pool(k, v, kpos, 8))
    posv = torch.tensor(pos, dtype=torch.int32)
    got = flash_decode_paged(q, kpool, vpool, kp, tables, posv)
    wide = torch.cat([tables, torch.ones((3, 5), dtype=torch.int32)], dim=1)
    assert torch.equal(flash_decode_paged(q, kpool, vpool, kp, wide, posv), got)


def test_layer_view_of_a_stacked_pool():
    """The serving pool is block-leading with the layer axis second, (N,
    layers, bl, KV, hd); one layer's strided view gives the same bits as
    the same blocks stored on their own."""
    pos = (5, 30)
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16), np.float32))
    k, v, kpos = ragged_cache(43, 2, 32, 2, 16, pos, 0)
    kpool, vpool, kp, tables = t(*as_pool(k, v, kpos, 8))
    n, layers = kpool.shape[0], 3
    stack = lambda x: torch.stack(  # noqa: E731
        [torch.randn_like(x.float()).to(x.dtype) if i != 1 else x for i in range(layers)], 1)
    ks, vs = stack(kpool), stack(vpool)
    kps = torch.stack([torch.full_like(kp, -1), kp, torch.full_like(kp, -1)], 1)
    view = ks[:, 1], vs[:, 1], kps[:, 1]
    assert not view[0].is_contiguous() and view[0].stride(0) == layers * 8 * 2 * 16
    posv = torch.tensor(pos, dtype=torch.int32)
    got = flash_decode_paged(q, *view, tables, posv)
    assert torch.equal(got, flash_decode_paged(q, kpool, vpool, kp, tables, posv))
    assert torch.equal(gather_pool(view[2], tables), gather_pool(kp, tables))


def test_bf16_storage_matches_jax():
    pos = (-1, 9, 31)
    q = np.random.default_rng(21).standard_normal((3, 1, 4, 16), np.float32)
    k, v, kpos = ragged_cache(47, 3, 32, 1, 16, pos, 0)
    kpool, vpool, kp, tables = as_pool(k, v, kpos, 8)
    want = np.asarray(jax_flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kpool, jnp.bfloat16), jnp.asarray(vpool, jnp.bfloat16),
        jnp.asarray(kp), jnp.asarray(tables), jnp.asarray(pos, jnp.int32), interpret=True))
    tq, tk, tv, tkp, ttab = t(q, kpool, vpool, kp, tables)
    got = flash_decode_paged_plain(tq, tk.to(torch.bfloat16), tv.to(torch.bfloat16), tkp,
                                   ttab, torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_cpu_tensors_count_no_launch():
    reset_launch_counts()
    q = torch.zeros((1, 1, 2, 8))
    pool = torch.zeros((3, 4, 2, 8))
    kp = torch.full((3, 4), -1, dtype=torch.int32)
    flash_decode_paged(q, pool, pool, kp, torch.tensor([[2, 1]], dtype=torch.int32),
                       torch.tensor([1], dtype=torch.int32))
    assert launch_counts()["flash_decode_paged"] == 0


def test_non_cpu_non_cuda_tensor_raises():
    """No silent fallback: only CPU tensors take the plain version."""
    q = torch.empty((1, 1, 2, 8), device="meta")
    pool = torch.empty((3, 4, 2, 8), device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_decode_paged(q, pool, pool, torch.empty((3, 4), **i32),
                           torch.empty((1, 2), **i32), torch.empty((1,), **i32))
