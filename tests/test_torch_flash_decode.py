"""Port's flash_decode (its plain version, on CPU tensors) and needed_tiles
vs the JAX package's Pallas kernel in interpret mode and its dense oracle,
on cases of tests/test_flash_decode.py: GQA ratios 1/2/4, full, unaligned
and rolling-window caches, float32 and bfloat16 storage, multi-row decode,
and empty slots, whose rows must be exact zeros.

Tolerance 2e-5 (float32 queries; bf16 storage is cast in the load by both,
so only the order of float32 sums differs)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.ops import flash_decode as jax_flash_decode
from repro.kernels.ops import needed_tiles as jax_needed_tiles
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_decode import flash_decode_paged_plain, flash_decode_plain
from repro_torch.kernels.ops import (
    flash_decode,
    launch_counts,
    multi_row_counts,
    needed_tiles,
    reset_launch_counts,
)

TOL = 2e-5
STORAGE = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def run_both(q, k, v, kpos, pos, storage, window, block_k, interpret):
    """(port plain, JAX Pallas interpret or None, port oracle, JAX oracle)."""
    jdt, tdt = STORAGE[storage]
    want = None
    if interpret:
        want = np.asarray(jax_flash_decode(
            jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(kpos),
            jnp.asarray(pos, jnp.int32), window=window, block_k=block_k, interpret=True))
    oracle = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                   jnp.asarray(kpos), jnp.asarray(pos, jnp.int32),
                                   window=window)
    tq = torch.from_numpy(q)
    tk, tv = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    tkpos, tpos = torch.from_numpy(kpos), torch.tensor(pos, dtype=torch.int32)
    got = flash_decode(tq, tk, tv, tkpos, tpos, window=window, block_k=block_k)
    tor = tref.flash_decode_ref(tq, tk, tv, tkpos, tpos, window=window)
    return got.numpy(), want, tor.numpy(), np.asarray(oracle)


CACHES = {  # window, s, block_k, pos
    "full": (0, 48, 16, (-1, 0, 15, 16, 17, 47)),  # tile boundaries, empty, full depth
    "unaligned": (0, 40, 16, (5, 39)),              # unaligned S
    "window": (8, 16, 8, (-1, 3, 15, 40)),          # rolling window (wrapped slots)
}
# Every GQA ratio (h = 4) and cache with float32 and bf16 storage (cast in
# the load) against the JAX oracle; the Pallas kernel in interpret mode, at
# a few seconds a case, on the diagonal of ratio and cache.
PARITY = [(kv, c, st) for st in STORAGE for kv in (4, 2, 1) for c in CACHES]
INTERPRET = {(4, "full"), (2, "window"), (1, "unaligned")}


@pytest.mark.parametrize("kv,cache,storage", PARITY,
                         ids=[f"kv{kv}-{c}-{st}" for kv, c, st in PARITY])
def test_plain_matches_jax(kv, cache, storage):
    window, s, block_k, pos = CACHES[cache]
    b, h, hd = len(pos), 4, 16
    q = np.random.default_rng(3).standard_normal((b, 1, h, hd), np.float32)
    k, v, kpos = ragged_cache(17, b, s, kv, hd, pos, window)
    interpret = (kv, cache) in INTERPRET
    got, want, tor, oracle = run_both(q, k, v, kpos, pos, storage, window, block_k,
                                      interpret)
    if interpret:
        np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(tor, oracle, atol=TOL)
    np.testing.assert_allclose(got, oracle, atol=TOL)
    for i, p in enumerate(pos):
        if p < 0:  # no valid keys: exact zeros
            assert not np.any(got[i])
            assert not np.any(tor[i])


@pytest.mark.parametrize("kv,sq", [(4, 2), (2, 4), (1, 4)])
def test_multirow_plain_matches_jax(kv, sq):
    """Sq rows per slot at consecutive positions, each masked at its own
    depth; cache written through pos + sq - 1."""
    s, block_k, h, hd = 48, 16, 4, 16
    pos = (-1, 0, 14, 15, 16, 48 - sq)
    written = [(-1 if p < 0 else min(p + sq - 1, s - 1)) for p in pos]
    q = np.random.default_rng(11).standard_normal((len(pos), sq, h, hd), np.float32)
    k, v, kpos = ragged_cache(29, len(pos), s, kv, hd, written, 0)
    got, want, tor, oracle = run_both(q, k, v, kpos, pos, "float32", 0, block_k, True)
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(tor, oracle, atol=TOL)
    assert not np.any(got[0, 0])  # row 0 of the empty slot sees no key


def test_plain_rows_are_batch_invariant():
    """A slot's output does not depend on the batch it is decoded in."""
    pos = (3, 17, 40)
    q = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 2, 4, 16), np.float32))
    k, v, kpos = (torch.from_numpy(x) for x in ragged_cache(7, 3, 48, 2, 16,
                                                            [p + 1 for p in pos], 0))
    posv = torch.tensor(pos, dtype=torch.int32)
    got = flash_decode(q, k, v, kpos, posv, block_k=16)
    for i in range(3):
        one = flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1], kpos[i:i + 1],
                           posv[i:i + 1], block_k=16)
        np.testing.assert_allclose(one[0].numpy(), got[i].numpy(), atol=1e-6)


def test_needed_tiles_math():
    kpos = np.asarray([
        [0, 1, 2, -1, -1, -1, -1, -1],     # 3 tokens deep
        [0, 1, 2, 3, 4, 5, 6, 7],          # full depth
        [-1, -1, -1, -1, -1, -1, -1, -1],  # empty
        [5, -1, -1, -1, -1, -1, -1, -1],   # deep pos, keys only in tile 0
    ], np.int32)
    for pos, window, sq, want in [
        ([2, 7, -1, 5], 0, 1, [1, 2, 1, 1]),
        ([2, 2, -1, 5], 0, 1, [1, 1, 1, 1]),   # masking by pos
        ([2, 7, -1, 5], 2, 1, [1, 2, 1, 1]),   # window
        ([3, 3, -1, 1], 0, 3, [1, 2, 1, 1]),   # multi-row union
    ]:
        pv = np.asarray(pos, np.int32)
        got = needed_tiles(torch.from_numpy(kpos), torch.from_numpy(pv), window=window,
                           block_k=4, sq=sq)
        ref = jax_needed_tiles(jnp.asarray(kpos), jnp.asarray(pv), window=window,
                               block_k=4, sq=sq)
        assert got.dtype == torch.int32
        assert got.tolist() == want == np.asarray(ref).tolist()


def test_cpu_tensors_count_no_launch():
    reset_launch_counts()
    q = torch.zeros((1, 1, 2, 8))
    k = torch.zeros((1, 4, 2, 8))
    kpos = torch.tensor([[0, 1, -1, -1]], dtype=torch.int32)
    flash_decode(q, k, k, kpos, torch.tensor([1], dtype=torch.int32))
    flash_decode(torch.zeros((1, 2, 2, 8)), k, k, kpos, torch.tensor([0], dtype=torch.int32))
    assert launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                               "flash_decode_paged": 0, "ssm_scan": 0,
                               "rglru_scan": 0, "gemm_rowinv": 0, "rms_norm": 0,
                               "moe_gemm": 0, "layer_norm": 0, "flash_attention_bwd": 0}
    assert multi_row_counts() == {"flash_decode": 0, "flash_decode_paged": 0}


def test_multi_row_launches_count_within_their_kernel():
    """A multi-row launch (a verify, Sq > 1) counts once under its own
    kernel and once more among the multi-row launches, the same way for
    both decode kernels; a reset zeroes both."""
    from repro_torch.kernels import _build

    reset_launch_counts()
    _build.count("flash_decode")
    _build.count("flash_decode", multi_row=True)
    _build.count("flash_decode_paged", multi_row=True)
    assert launch_counts()["flash_decode"] == 2
    assert launch_counts()["flash_decode_paged"] == 1
    assert multi_row_counts() == {"flash_decode": 1, "flash_decode_paged": 1}
    reset_launch_counts()
    assert launch_counts()["flash_decode"] == 0
    assert multi_row_counts() == {"flash_decode": 0, "flash_decode_paged": 0}


def test_non_cpu_non_cuda_tensor_raises():
    """No silent fallback: only CPU tensors take the plain version."""
    q = torch.empty((1, 1, 2, 8), device="meta")
    kpos = torch.empty((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_decode(q, q, q, kpos, kpos[:, 0])


# Decode shapes the card launches (chip_smoke.py's cases and main paths):
# b, s, sq, h, kv, hd, block_k, q dtype, cache dtype, body.
CHIP_DECODE = {
    "qwen1.5-4b last step (main path)": (8, 288, 1, 20, 20, 128, 128, "bfloat16", "bfloat16",
                                         "mma"),
    "qwen1.5-4b f32": (8, 288, 1, 20, 20, 128, 128, "float32", "float32", "fma"),
    "internlm2-20b widths": (4, 300, 1, 48, 8, 128, 128, "bfloat16", "bfloat16", "mma"),
    "multi-row Sq 3": (4, 300, 3, 48, 8, 128, 128, "bfloat16", "bfloat16", "mma"),
    "64 rows": (2, 256, 8, 32, 4, 128, 64, "bfloat16", "bfloat16", "mma"),
    "windowed ring 64": (4, 64, 1, 20, 20, 128, 32, "bfloat16", "bfloat16", "mma"),
    "f32 cache, bf16 q": (2, 300, 1, 48, 8, 128, 128, "bfloat16", "float32", "mma"),
    "recurrentgemma-2b (main path)": (8, 288, 1, 10, 1, 256, 128, "bfloat16", "bfloat16",
                                      "mma"),
    "recurrentgemma-2b wrapped ring": (2, 2048, 1, 10, 1, 256, 128, "bfloat16", "bfloat16",
                                       "mma"),
    "recurrentgemma-2b 2 x 300 + 8": (2, 308, 1, 10, 1, 256, 128, "bfloat16", "bfloat16",
                                      "mma"),
    "served one-shot at block_k 16": (8, 288, 1, 20, 20, 128, 16, "bfloat16", "bfloat16",
                                      "mma"),
}


@pytest.mark.parametrize("name", list(CHIP_DECODE))
def test_launch_plan_admits_chip_shapes(name):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import launch_plan

    b, s, sq, h, kv, hd, bk, qdt, kvdt, route = CHIP_DECODE[name]
    plan = launch_plan(b, s, sq, h, kv, hd, getattr(torch, qdt), getattr(torch, kvdt),
                       block_k=bk)
    assert plan["route"] == route and plan["smem"] <= _build.MAX_SMEM
    if route == "mma":
        assert plan["row_blocks"] == -(-sq * (h // kv) // plan["block_rows"])
        assert plan["grid"] == (kv * plan["row_blocks"], b, plan["chunks"])
        assert plan["chunks"] == -(-plan["tiles"] // plan["chunk_tiles"])
        assert plan["scratch_floats"] == (
            b * kv * (plan["chunks"] * plan["rows"] * (hd + 2) + 1) if plan["chunks"] > 1 else 0)
    else:
        assert plan["grid"] == (kv, b) and plan["chunks"] == 1


@pytest.mark.parametrize("args,match", [
    ((1, 64, 9, 8, 1, 128, torch.bfloat16, torch.bfloat16), "rows"),
    ((1, 64, 1, 4, 3, 128, torch.bfloat16, torch.bfloat16), "multiple of KV"),
    ((1, 64, 1, 4, 4, 1024, torch.float32, torch.float32), "too wide"),
    ((1, 64, 1, 4, 4, 128, torch.bfloat16, torch.float8_e4m3fn), "float32 or bfloat16"),
], ids=["rows", "gqa-ratio", "f32-too-wide", "fp8-cache"])
def test_launch_plan_rejects(args, match):
    from repro_torch.kernels.flash_decode import launch_plan

    with pytest.raises(ValueError, match=match):
        launch_plan(*args)


@pytest.mark.parametrize("block_k", [16, 32, 64, 128])
def test_chunk_plan_depends_on_block_k_alone(block_k):
    """A slot's key chunks are chunk_tiles(block_k) tiles whatever the batch
    and the cache length: the split never changes a slot's sums."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import launch_plan

    want = max(1, _build.CHUNK_KEYS // block_k)
    seen = set()
    for b in (1, 2, 8, 64):
        for s in (block_k, 3 * block_k + 5, 2048, 4096):
            plan = launch_plan(b, s, 1, 20, 20, 128, torch.bfloat16, torch.bfloat16,
                               block_k=block_k)
            seen.add(plan["chunk_tiles"])
            assert plan["chunks"] == -(-(-(-s // block_k)) // want)
    assert seen == {want}


@pytest.mark.parametrize("nmax,bl,sq,h,kv,hd", [
    (18, 16, 1, 20, 20, 128),  # the served path's last step
    (21, 16, 1, 48, 8, 128),
    (21, 16, 4, 48, 8, 128),
    (40, 16, 1, 20, 20, 128),  # three key chunks
    (6, 32, 1, 10, 1, 256),
])
def test_paged_and_contiguous_take_the_same_chunks(nmax, bl, sq, h, kv, hd):
    """flash_decode_paged over nmax blocks of bl keys runs flash_decode's
    plan at block_k = bl on the gathered (B, nmax*bl) layout: same body,
    chunks, grid and shared memory, hence the same bits."""
    from repro_torch.kernels.flash_decode import launch_plan, paged_launch_plan

    for b in (1, 8):
        paged = paged_launch_plan(b, nmax, bl, sq, h, kv, hd, torch.bfloat16, torch.bfloat16)
        contig = launch_plan(b, nmax * bl, sq, h, kv, hd, torch.bfloat16, torch.bfloat16,
                             block_k=bl)
        assert paged == contig
        assert paged["route"] == "mma"


# --------------------------------------------------- speculative verify rows
@pytest.mark.parametrize("n_rep", [1, 4, 6, 8])
def test_verify_plan_splits_keys_as_one_row(n_rep):
    """The tensor-core body's key parts and stage width depend on (bk, hd,
    n_rep) alone: every Sq with Sq * n_rep <= MAX_ROWS takes the one-row
    launch's plan (more row blocks where the rows outgrow one block), on
    both decode kernels; past MAX_ROWS the wrapper's plan raises."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import launch_plan, paged_launch_plan

    kv = 2
    h = kv * n_rep
    for bk, hd in ((128, 128), (16, 128), (64, 64), (128, 256)):
        one = launch_plan(8, 312, 1, h, kv, hd, torch.bfloat16, torch.bfloat16, block_k=bk)
        pone = paged_launch_plan(8, 20, 16, 1, h, kv, hd, torch.bfloat16, torch.bfloat16)
        assert one["row_blocks"] == pone["row_blocks"] == 1
        for sq in range(1, _build.MAX_ROWS // n_rep + 1):
            for plan, ref in (
                    (launch_plan(8, 312, sq, h, kv, hd, torch.bfloat16, torch.bfloat16,
                                 block_k=bk), one),
                    (paged_launch_plan(8, 20, 16, sq, h, kv, hd, torch.bfloat16,
                                       torch.bfloat16), pone)):
                assert plan["route"] == "mma"
                for key in ("key_parts", "stage_keys", "block_rows", "chunks", "chunk_tiles",
                            "smem"):
                    assert plan[key] == ref[key], (bk, hd, sq, key)
                assert plan["row_blocks"] == -(-sq * n_rep // plan["block_rows"])
                assert plan["grid"] == (kv * plan["row_blocks"], 8, plan["chunks"])
        with pytest.raises(ValueError, match="rows"):
            launch_plan(8, 312, _build.MAX_ROWS // n_rep + 1, h, kv, hd, torch.bfloat16,
                        torch.bfloat16, block_k=bk)
        with pytest.raises(ValueError, match="rows"):
            paged_launch_plan(8, 20, 16, _build.MAX_ROWS // n_rep + 1, h, kv, hd,
                              torch.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("n_rep", [1, 4, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_plain_verify_rows_equal_one_row_calls(n_rep, dtype, k):
    """flash_decode_plain's row j at Sq = k + 1 (keys written through pos +
    k) is bitwise its one-row call at pos + j over the same cache, across a
    128-key tile seam, for an empty slot (exact zeros) and through the paged
    plain version."""
    rng = np.random.default_rng(n_rep * 10 + k)
    b, s, kv, hd = 3, 300, 2, 32
    h, sq, dt = kv * n_rep, k + 1, getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, hd)).astype(np.float32)).to(dt)
    kk = torch.from_numpy(rng.standard_normal((b, s, kv, hd)).astype(np.float32)).to(dt)
    vv = torch.from_numpy(rng.standard_normal((b, s, kv, hd)).astype(np.float32)).to(dt)
    pos = torch.tensor([126, -1, 290 - k], dtype=torch.int32)
    kpos = torch.full((b, s), -1, dtype=torch.int32)
    for i, p in enumerate(pos.tolist()):
        if p >= 0:
            kpos[i, :p + sq] = torch.arange(p + sq)
    full = flash_decode_plain(q, kk, vv, kpos, pos)
    assert torch.all(full[1] == 0)
    for j in range(sq):
        one = flash_decode_plain(q[:, j:j + 1], kk, vv, kpos, pos + j)
        assert torch.equal(one[:, 0], full[:, j]), j
    bl = 20
    tables = torch.arange(2, 2 + b * (s // bl), dtype=torch.int32).reshape(b, s // bl)
    pool = [torch.zeros((2 + b * (s // bl), bl) + tuple(x.shape[2:]), dtype=x.dtype)
            for x in (kk, vv, kpos)]
    for p, x in zip(pool, (kk, vv, kpos)):
        p[2:] = x.reshape((-1, bl) + tuple(x.shape[2:]))
    paged = flash_decode_paged_plain(q, *pool, tables, pos)
    for j in range(sq):
        one = flash_decode_paged_plain(q[:, j:j + 1], *pool, tables, pos + j)
        assert torch.equal(one[:, 0], paged[:, j]), j
