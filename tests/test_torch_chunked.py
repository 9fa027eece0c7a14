"""Chunked prefill in the port vs the JAX package: ports of
tests/test_chunked_prefill.py (without the draft cases) on reduced
qwen1.5-4b and internlm2-20b, float32, weights materialized in JAX and
loaded with ``load_jax_params``.

- ``chunk_attention`` and ``prefill_chunk`` against the JAX package's, the
  port's "reference" path against JAX "reference" and the port's "cuda"
  path (CPU tensors: the kernels' plain versions) against JAX
  "pallas_interpret", on contiguous and paged caches: 2e-5 in float32,
  2e-2 in bfloat16.
- Invalid chunk rows leave the cache bitwise unchanged: a prefilling
  slot's tail past its prompt, a decoding slot's live entries, and every
  block of a paged pool but the sink.
- ``flash_decode_chunk_plain``'s rows bitwise equal to
  ``flash_attention_plain``'s at the same positions, and the chunk launch
  plan (row groups past 64 rows, no key chunks, the prefill block's key
  parts), computed without a card.
- Served: chunked streams bitwise equal to whole-prompt served streams, to
  the port's batch-1 one-shot generate and to the JAX package's tokens;
  paged chunks straddling the block length, prefix-cache hits, mid-stream
  joins; the per-chunk admission forecast; every ``validate_chunked``
  rejection."""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import attention as jattn
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.core import DeviceGroup, Static
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels.ops import launch_counts, reset_launch_counts
from repro_torch.launch import serve as launcher
from repro_torch.models import attention as tattn
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import (
    DeadlineAdmission,
    InferenceServer,
    PagedSpec,
    ServiceModel,
    chunks_for,
    make_chunk_step,
    make_generate,
    validate_chunked,
)

PLEN, GEN = 8, 6
F32_TOL, BF16_TOL = 2e-5, 2e-2
ARCHS = ["qwen1.5-4b", "internlm2-20b"]
IMPLS = [("reference", "reference"), ("cuda", "pallas_interpret")]


def _jax_weights(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1),
                             jax.random.PRNGKey(0), jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    return _jax_weights(request.param)


@pytest.fixture(scope="module")
def qwen():
    """(JAX cfg, JAX params, port cfg, port params) of reduced qwen1.5-4b."""
    return _jax_weights("qwen1.5-4b")


def _close(t, j, tol=F32_TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol)


# --------------------------------------------------------- chunk attention
def _cache_case(rng, b, s, kv, hd, cursors, sq):
    """k/v random everywhere (stale values under kpos -1 included) and
    kpos = i for logical index i below each slot's cursor + sq, else -1."""
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    kp = np.full((b, s), -1, np.int32)
    for i, c in enumerate(cursors):
        kp[i, :min(s, c + sq)] = np.arange(min(s, c + sq))
    return k, v, kp


@pytest.mark.parametrize("impls", IMPLS, ids=[i[0] for i in IMPLS])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_attention_matches_jax(impls, paged, dtype):
    rng = np.random.default_rng(3)
    b, s, h, kv, hd, sq = 3, 24, 4, 1, 16, 5
    cursors = [0, 7, 19]
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k, v, kp = _cache_case(rng, b, s, kv, hd, cursors, sq)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("internlm2-20b")),
                               kernel_impl=impls[0])
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config("internlm2-20b")),
                               kernel_impl=impls[1])
    if paged:
        bl = 4
        nmax = s // bl
        perm = rng.permutation(np.arange(2, 2 + b * nmax)).reshape(b, nmax).astype(np.int32)
        n_blocks = 2 + b * nmax
        pool_k = np.zeros((n_blocks, bl, kv, hd), np.float32)
        pool_v = np.zeros_like(pool_k)
        pool_p = np.full((n_blocks, bl), -1, np.int32)
        for i in range(b):
            for t in range(nmax):
                pool_k[perm[i, t]] = k[i, t * bl:(t + 1) * bl]
                pool_v[perm[i, t]] = v[i, t * bl:(t + 1) * bl]
                pool_p[perm[i, t]] = kp[i, t * bl:(t + 1) * bl]
        leaves = {"k": pool_k, "v": pool_v, "pos": pool_p, "table": perm}
    else:
        leaves = {"k": k, "v": v, "pos": kp}
    jc = {n: jnp.asarray(a).astype(jdt) if a.dtype == np.float32 else jnp.asarray(a)
          for n, a in leaves.items()}
    tc = {n: torch.from_numpy(a).to(tdt) if a.dtype == np.float32 else torch.from_numpy(a)
          for n, a in leaves.items()}
    posv = np.asarray(cursors, np.int32)
    want = jattn.chunk_attention(jnp.asarray(q).astype(jdt), jc, jnp.asarray(posv), jcfg)
    got = tattn.chunk_attention(torch.from_numpy(q).to(tdt), tc, torch.from_numpy(posv), tcfg)
    assert got.dtype == tdt and tuple(got.shape) == (b, sq, h, hd)
    _close(got, np.asarray(want.astype(jnp.float32)),
           F32_TOL if dtype == "float32" else BF16_TOL)


# ----------------------------------------------------- prefill_chunk (model)
def _paged_stack(cache, bl):
    """A layer-stacked contiguous cache laid out as a block pool: slot b's
    logical block t is physical block 2 + t * B + b (blocks 0 and 1 are the
    sink and the null block); the table rides every layer."""
    n_layers, b, s = cache["pos"].shape
    nmax = s // bl
    table = (2 + np.arange(nmax)[None, :] * b + np.arange(b)[:, None]).astype(np.int32)
    n_blocks = 2 + b * nmax

    def pool(a, fill):
        out = np.full((n_layers, n_blocks, bl) + a.shape[3:], fill, a.dtype)
        for i in range(b):
            for t in range(nmax):
                out[:, table[i, t]] = a[:, i, t * bl:(t + 1) * bl]
        return out

    return {"k": pool(cache["k"], 0), "v": pool(cache["v"], 0),
            "pos": pool(cache["pos"], -1),
            "table": np.broadcast_to(table[None], (n_layers,) + table.shape).copy()}


@pytest.mark.parametrize("impls", IMPLS, ids=[i[0] for i in IMPLS])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_prefill_chunk_matches_jax(weights, impls, paged):
    """Two chunk stages of 3 rows through both packages' chunk steps
    (``make_chunk_step``) over staggered cursors (a fresh slot, one
    mid-prompt, one decoding): the first-token logits, the argmax, the
    cursors and the caches agree; recorded positions exactly."""
    jcfg, jp, tcfg, tp = weights
    jcfg = dataclasses.replace(jcfg, kernel_impl=impls[1])
    tcfg = dataclasses.replace(tcfg, kernel_impl=impls[0])
    japi, tapi = jax_get_model(jcfg), get_model(tcfg)
    b, max_seq, chunk_len = 3, 16, 3
    rng = np.random.default_rng(5)
    ptoks = rng.integers(0, tcfg.vocab, (b, PLEN)).astype(np.int32)
    jcache = jax.tree_util.tree_map(np.asarray, jserve.zeros_cache(jcfg, japi, b, max_seq))
    if paged:
        jcache = _paged_stack(jcache, 4)
    tcache = {n: torch.from_numpy(np.array(a)) for n, a in jcache.items()}
    jcache = {n: jnp.asarray(a) for n, a in jcache.items()}
    jstep = jserve.make_chunk_step(jcfg, japi, PLEN, chunk_len)
    tstep = make_chunk_step(tcfg, tapi, PLEN, chunk_len)
    pcur = np.asarray([[0], [4], [PLEN]], np.int32)
    jpcur, tpcur = jnp.asarray(pcur), torch.from_numpy(pcur)
    for _ in range(2):
        jtok, jpcur, jcache = jstep(jp, jcache, jnp.asarray(ptoks), jpcur)
        ttok, tpcur, tcache = tstep(tp, tcache, torch.from_numpy(ptoks), tpcur)
        np.testing.assert_array_equal(tpcur.numpy(), np.asarray(jpcur))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tpcur.numpy(), [[6], [PLEN], [PLEN]])
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    # Logits of the completing slot's last prompt row, directly.
    posv = np.asarray([6, 7, PLEN], np.int32)
    valid = (posv[:, None] + np.arange(2)) < PLEN
    toks = ptoks[:, :2]
    last = np.asarray([1, 0, 0], np.int32)
    jl, _ = japi.prefill_chunk(jp, jnp.asarray(toks), jnp.asarray(posv), jnp.asarray(valid),
                               jcfg, jcache, jnp.asarray(last))
    tl, _ = tapi.prefill_chunk(tp, torch.from_numpy(toks), torch.from_numpy(posv),
                               torch.from_numpy(valid), tcfg, tcache, torch.from_numpy(last))
    assert tuple(tl.shape) == (b, 1, tcfg.vocab)
    _close(tl, jl)


def test_recurrent_families_have_no_chunk_path():
    for arch in ("falcon-mamba-7b", "recurrentgemma-2b"):
        cfg = tconfigs.reduced(tconfigs.get_config(arch))
        assert get_model(cfg).prefill_chunk is None
        assert jax_get_model(jconfigs.reduced(jconfigs.get_config(arch))).prefill_chunk is None
    cfg = tconfigs.reduced(tconfigs.get_config("qwen1.5-4b"))
    assert get_model(cfg).prefill_chunk is not None


# ------------------------------------------------------- invalid rows write
def _attn_params(cfg, seed=0):
    spec = get_model(cfg).param_spec(cfg)["layers"]["attn"]
    p = tparams.materialize(spec, torch.Generator().manual_seed(seed), torch.float32, "cpu")
    return {n: a[0] for n, a in p.items()}  # layer 0 of the stacked tree


def test_invalid_rows_leave_contiguous_cache_unchanged():
    """Slot 0 prefills rows 2..5 with a prompt of 4 (rows at 4 and 5 are
    past its prompt, on its live entries); slot 1 decodes (cursor at the
    bucket, every row on a live decode entry); slot 2 decodes at the end of
    its row (rows past the cache length).  Only slot 0's positions 2 and 3
    change."""
    cfg = tconfigs.reduced(tconfigs.get_config("internlm2-20b"))
    p = _attn_params(cfg)
    b, cs, sq, bucket = 3, 8, 4, 4
    g = torch.Generator().manual_seed(1)
    cache = {"k": torch.randn((b, cs, cfg.n_kv_heads, cfg.hd), generator=g),
             "v": torch.randn((b, cs, cfg.n_kv_heads, cfg.hd), generator=g),
             "pos": torch.arange(cs, dtype=torch.int32).repeat(b, 1)}
    before = {n: a.clone() for n, a in cache.items()}
    posv = torch.tensor([2, bucket, 6], dtype=torch.int32)
    valid = (posv[:, None] + torch.arange(sq)) < bucket
    x = torch.randn((b, sq, cfg.d_model), generator=g)
    tattn.chunk_step(p, x, posv, valid, cfg, cache)
    changed = torch.zeros((b, cs), dtype=torch.bool)
    changed[0, 2:4] = True
    for n in ("k", "v"):
        diff = (cache[n] != before[n]).flatten(2).any(-1)
        assert torch.equal(diff, changed), (n, diff)
    assert torch.equal(cache["pos"], before["pos"])  # positions rewritten with themselves
    # Every written entry is the valid row's own key.
    _, k, _ = tattn._project_qkv(p, x, posv[:, None] + torch.arange(sq), cfg)
    assert torch.equal(cache["k"][0, 2:4], k[0, :2])


def test_invalid_rows_write_only_the_paged_sink():
    cfg = tconfigs.reduced(tconfigs.get_config("internlm2-20b"))
    p = _attn_params(cfg)
    b, bl, nmax, sq, bucket = 2, 4, 3, 3, 6
    n_blocks = 2 + b * nmax
    g = torch.Generator().manual_seed(2)
    table = torch.tensor([[2, 3, 4], [5, 6, 7]], dtype=torch.int32)
    cache = {"k": torch.randn((n_blocks, bl, cfg.n_kv_heads, cfg.hd), generator=g),
             "v": torch.randn((n_blocks, bl, cfg.n_kv_heads, cfg.hd), generator=g),
             "pos": torch.full((n_blocks, bl), -1, dtype=torch.int32), "table": table}
    before = {n: a.clone() for n, a in cache.items()}
    posv = torch.tensor([4, bucket], dtype=torch.int32)  # rows 4, 5 valid; slot 1 decoding
    valid = (posv[:, None] + torch.arange(sq)) < bucket
    tattn.chunk_step(p, torch.randn((b, sq, cfg.d_model), generator=g), posv, valid, cfg, cache)
    for n in ("k", "v", "pos"):
        diff = (cache[n] != before[n]).reshape(n_blocks, bl, -1).any(-1)
        want = torch.zeros((n_blocks, bl), dtype=torch.bool)
        want[3, 0:2] = True  # slot 0's positions 4 and 5: block table[0, 1], offsets 0, 1
        want[0] = diff[0]    # the sink takes whatever the invalid rows wrote
        assert torch.equal(diff, want), (n, diff)
        assert diff[0].any()
    assert torch.equal(cache["pos"][3, :2], torch.tensor([4, 5], dtype=torch.int32))


# -------------------------------------------------- plain chunk launch rows
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,cursors", [(32, [0, 32, 64, 96]), (40, [0, 40, 80, 96]),
                                           (7, [0, 63, 64, 121])])
def test_plain_chunk_rows_equal_flash_attention_plain(n_rep, dtype, chunk, cursors):
    """On a cache holding a prompt's keys (stale values under kpos -1 past
    each slot's rows), a chunk of rows at each cursor equals
    ``flash_attention_plain``'s rows of the whole prompt at the same
    positions, bitwise."""
    dt = getattr(torch, dtype)
    b, plen, s, kv, hd = len(cursors), 128, 144, 2, 16
    h = kv * n_rep
    g = torch.Generator().manual_seed(n_rep + chunk)
    q = torch.randn((b, plen, h, hd), generator=g).to(dt)
    k = torch.randn((b, s, kv, hd), generator=g).to(dt)
    v = torch.randn((b, s, kv, hd), generator=g).to(dt)
    whole = tfa.flash_attention_plain(q, k[:, :plen], v[:, :plen])
    kpos = torch.full((b, s), -1, dtype=torch.int32)
    qc = torch.zeros((b, chunk, h, hd), dtype=dt)
    for i, c in enumerate(cursors):
        end = min(plen, c + chunk)
        kpos[i, :end] = torch.arange(end, dtype=torch.int32)
        qc[i, :end - c] = q[i, c:end]
    pos = torch.tensor(cursors, dtype=torch.int32)
    got = tfd.flash_decode_chunk_plain(qc, k, v, kpos, pos)
    for i, c in enumerate(cursors):
        end = min(plen, c + chunk)
        assert torch.equal(got[i, :end - c], whole[i, c:end]), (i, c)


def test_chunk_launch_plan():
    bf, f32 = torch.bfloat16, torch.float32
    fa = tfa.launch_plan(8, 256, 256, 20, 20, 128, bf)
    # qwen1.5-4b's served chunk: one 64-row group per (kv head, slot).
    p = tfd.chunk_launch_plan(8, 288, 64, 20, 20, 128, bf, bf)
    assert p["route"] == "mma" and p["grid"] == (20, 8, 1) and p["chunks"] == 1
    assert p["block_k"] == fa["block_k"] == tfa.BLOCK_K == 64
    assert p["stage_keys"] == fa["stage_keys"]
    assert p["key_parts"] == _build.mma_plan(_build.MMA_ROWS, 64, 128)[0] == 1
    assert p["smem"] == fa["smem"] and p["tiles"] == 5
    # internlm2-20b widths (n_rep 6): 384 rows, six row groups, any Sq.
    p = tfd.chunk_launch_plan(8, 288, 64, 48, 8, 128, bf, bf)
    assert p["rows"] == 384 and p["grid"] == (8, 8, 6) and p["key_parts"] == 1
    # A short chunk keeps the 64-row block's key parts (flash_decode's
    # decode plan would split the keys four ways).
    p = tfd.chunk_launch_plan(8, 288, 3, 20, 20, 128, bf, bf)
    assert p["grid"] == (20, 8, 1) and p["key_parts"] == 1
    assert tfd.launch_plan(8, 288, 3, 20, 20, 128, bf, bf)["key_parts"] == 4
    # A chunk of 200 rows with no GQA: four groups; hd 256 at the prefill plan.
    assert tfd.chunk_launch_plan(2, 300, 200, 20, 20, 128, bf, bf)["grid"] == (20, 2, 4)
    p = tfd.chunk_launch_plan(2, 300, 40, 10, 1, 256, bf, bf)
    assert p["stage_keys"] == tfa.launch_plan(2, 300, 300, 10, 1, 256, bf)["stage_keys"]
    # float32 takes the FMA body on flash_attention's grid.
    p = tfd.chunk_launch_plan(8, 288, 100, 20, 20, 128, f32, f32)
    assert p["route"] == "fma" and p["grid"] == (2, 160)
    assert p["smem"] == tfa.launch_plan(8, 256, 256, 20, 20, 128, f32)["smem"]
    with pytest.raises(ValueError, match="multiple of KV"):
        tfd.chunk_launch_plan(1, 64, 4, 6, 4, 128, bf, bf)


def test_chunk_wrapper_counts_no_launch_on_cpu():
    reset_launch_counts()
    q = torch.zeros((1, 70, 2, 16))
    k = torch.zeros((1, 80, 2, 16))
    kpos = torch.full((1, 80), -1, dtype=torch.int32)
    out = tfd.flash_decode_chunk(q, k, k, kpos, torch.tensor([0], dtype=torch.int32))
    assert tuple(out.shape) == (1, 70, 2, 16) and not torch.any(out)  # no key: zeros
    assert launch_counts()["flash_decode"] == 0
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kv = torch.empty((1, 8, 2, 16), **meta)
        tfd.flash_decode_chunk(torch.empty((1, 2, 2, 16), **meta), kv, kv,
                               torch.empty((1, 8), dtype=torch.int32, **meta),
                               torch.empty((1,), dtype=torch.int32, **meta))


# ------------------------------------------------------------- served paths
def prompts_for(vocab, seed, n, plen=PLEN):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen).astype(np.int32) for _ in range(n)]


def port_model(qwen, impl="reference", block_len=4):
    _, _, tcfg, tp = qwen
    cfg = dataclasses.replace(tcfg, kernel_impl=impl,
                              decode_block=block_len if impl == "cuda" else 0)
    return cfg, get_model(cfg), tp


def serve_all(cfg, api, params, prompts, gen=GEN, gens=None, **kw):
    kw.setdefault("groups", [DeviceGroup("chunked", device="cpu")])
    kw.setdefault("scheduler", Static())
    kw.setdefault("buckets", (PLEN,))
    kw.setdefault("max_batch", 4)
    kw.setdefault("seg_len", 2)
    kw.setdefault("max_new_cap", 10)
    kw.setdefault("max_wait_ms", 5.0)
    gens = gens or [gen] * len(prompts)
    with InferenceServer(cfg, api, params, **kw) as srv:
        handles = [srv.submit(p, n) for p, n in zip(prompts, gens)]
        results = [h.result(timeout=300) for h in handles]
        stats = srv.stats()
    return results, stats


def oneshot(cfg, api, params, prompt, n):
    return make_generate(cfg, api)(params, {"tokens": torch.from_numpy(prompt[None])}, n)[0].numpy()


def jax_oneshot(qwen, prompt, n):
    jcfg, jp, _, _ = qwen
    gen = jserve.make_generate(jcfg, jax_get_model(jcfg))
    return np.asarray(gen(jp, {"tokens": jnp.asarray(prompt[None])}, n))[0]


@pytest.mark.parametrize("impl", ["reference", "cuda"])
@pytest.mark.parametrize("chunk_len", [1, 3, PLEN])
def test_contiguous_chunked_bit_identical(qwen, impl, chunk_len):
    """Chunked == whole == batch-1 one-shot, including a chunk_len that
    does not divide the bucket and one that covers the whole prompt in a
    single segment; under "cuda" chunk rows take flash_decode_chunk's plain
    version and whole-prompt rows flash_attention's."""
    cfg, api, params = port_model(qwen, impl)
    prompts = prompts_for(cfg.vocab, 21, 6)
    got, stats = serve_all(cfg, api, params, prompts, chunk_len=chunk_len)
    whole, _ = serve_all(cfg, api, params, prompts)
    for p, r, w in zip(prompts, got, whole):
        np.testing.assert_array_equal(r, w)
        np.testing.assert_array_equal(r, oneshot(cfg, api, params, p, GEN))
    if chunk_len == 3:
        for p, r in zip(prompts[:2], got):
            np.testing.assert_array_equal(r, jax_oneshot(qwen, p, GEN))
    assert stats["completed"] == 6 and stats["chunk_len"] == chunk_len
    assert stats["failed"] == 0


@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_paged_chunked_straddles_block_len(qwen, impl):
    """chunk_len=3 against block_len=4: chunk boundaries land mid-block and
    across block seams; the paged write path (and, under "cuda", the
    gather before flash_decode_chunk) still gives the exact streams."""
    cfg, api, params = port_model(qwen, impl)
    prompts = prompts_for(cfg.vocab, 22, 6)
    got, stats = serve_all(cfg, api, params, prompts, chunk_len=3,
                           paged=PagedSpec(block_len=4))
    whole, _ = serve_all(cfg, api, params, prompts, paged=PagedSpec(block_len=4))
    for p, r, w in zip(prompts, got, whole):
        np.testing.assert_array_equal(r, w)
        np.testing.assert_array_equal(r, oneshot(cfg, api, params, p, GEN))
    np.testing.assert_array_equal(got[0], jax_oneshot(qwen, prompts[0], GEN))
    assert stats["completed"] == 6 and stats["memory"]["mode"] == "paged"
    assert stats["memory"]["tokens_written"] > 0


def test_paged_chunked_whole_prompt_cache_hit(qwen):
    """A prompt served once registers its blocks; resubmitting it skips the
    chunk stage (the whole-prompt hit boards decoding at merge) and still
    emits the identical stream."""
    cfg, api, params = port_model(qwen)
    prompt = prompts_for(cfg.vocab, 26, 1)[0]
    want = oneshot(cfg, api, params, prompt, GEN)
    with InferenceServer(cfg, api, params, groups=[DeviceGroup("hit", device="cpu")],
                         scheduler=Static(), buckets=(PLEN,), max_batch=4, seg_len=2,
                         max_new_cap=10, max_wait_ms=5.0, chunk_len=3,
                         paged=PagedSpec(block_len=4)) as srv:
        first = srv.submit(prompt, GEN).result(timeout=300)
        segs = srv.stats()["segments"]
        second = srv.submit(prompt, GEN).result(timeout=300)
        stats = srv.stats()
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)
    assert stats["memory"]["prefix_hits"] >= 1, stats["memory"]
    # No chunk segment the second time: only its ceil(5 / 2) decode segments.
    assert stats["segments"] - segs == 3


def test_paged_chunked_chain_head_start(qwen):
    """A prompt sharing only its leading block with a served one gets a
    chunk-cursor head start from the chain cache (prefill resumes
    mid-prompt), and the output still matches one-shot generate."""
    cfg, api, params = port_model(qwen)
    a = prompts_for(cfg.vocab, 27, 1)[0]
    b = a.copy()
    b[4:] = (b[4:] + 1) % cfg.vocab  # same first block (block_len=4), new tail
    with InferenceServer(cfg, api, params, groups=[DeviceGroup("chain", device="cpu")],
                         scheduler=Static(), buckets=(PLEN,), max_batch=4, seg_len=2,
                         max_new_cap=10, max_wait_ms=5.0, chunk_len=3,
                         paged=PagedSpec(block_len=4)) as srv:
        got_a = srv.submit(a, GEN).result(timeout=300)
        got_b = srv.submit(b, GEN).result(timeout=300)
        stats = srv.stats()
    np.testing.assert_array_equal(got_a, oneshot(cfg, api, params, a, GEN))
    np.testing.assert_array_equal(got_b, oneshot(cfg, api, params, b, GEN))
    mem = stats["memory"]
    assert mem["prefix_hits"] >= 1 and mem["prefix_blocks_shared"] >= 1, mem


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_midstream_join_and_exit_chunked(qwen, paged):
    """Requests with staggered lengths join while earlier ones decode and
    exit at different segments; every stream stays bitwise one-shot's and
    at least one join happens mid-stream."""
    cfg, api, params = port_model(qwen)
    prompts = prompts_for(cfg.vocab, 28, 6)
    gens = [6, 4, 5, 6, 4, 5]
    kw = dict(paged=PagedSpec(block_len=4)) if paged else {}
    with InferenceServer(cfg, api, params, groups=[DeviceGroup("join", device="cpu")],
                         scheduler=Static(), buckets=(PLEN,), max_batch=3, seg_len=2,
                         max_new_cap=10, max_wait_ms=2.0, chunk_len=3, **kw) as srv:
        handles = []
        for i, (p, n) in enumerate(zip(prompts, gens)):
            handles.append(srv.submit(p, n))
            time.sleep(0.05 if i == 2 else 0.0)  # force a later second wave
        results = [h.result(timeout=300) for h in handles]
        stats = srv.stats()
    for p, n, r in zip(prompts, gens, results):
        np.testing.assert_array_equal(r, oneshot(cfg, api, params, p, n))
    assert stats["completed"] == 6
    assert stats["midstream_joins"] >= 1, stats


@pytest.mark.parametrize("impl", ["reference", "cuda"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_mixed_segments_bit_identical(qwen, impl, paged):
    """Prompts join one at a time, each once the previous one decodes, so
    segments mix decoding slots with prefilling ones: the decoding slots'
    chunk rows (masked, at their live decode positions) must not touch
    their caches, and every stream stays bitwise one-shot's."""
    from repro_torch.core.trace import Tracer, set_tracer, tracer

    cfg, api, params = port_model(qwen, impl)
    prompts = prompts_for(cfg.vocab, 31, 3)
    kw = dict(paged=PagedSpec(block_len=4)) if paged else {}
    prev = tracer()
    set_tracer(Tracer(capacity=1 << 14, enabled=True))
    try:
        with InferenceServer(cfg, api, params, groups=[DeviceGroup("mix", device="cpu")],
                             scheduler=Static(), buckets=(PLEN,), max_batch=3, seg_len=2,
                             max_new_cap=10, max_wait_ms=1.0, chunk_len=3, **kw) as srv:
            handles = []
            for p in prompts:
                handles.append(srv.submit(p, 10))
                t0 = time.monotonic()
                while handles[-1].t_first_token is None and time.monotonic() - t0 < 60:
                    time.sleep(0.001)
            results = [h.result(timeout=300) for h in handles]
        segs = [e["args"] for e in tracer().chrome_events()
                if e.get("ph") == "X" and e["name"] == "segment"]
    finally:
        set_tracer(prev)
    for p, r in zip(prompts, results):
        np.testing.assert_array_equal(r, oneshot(cfg, api, params, p, 10))
    mixed = sum(a["chunk_tokens"] > 0 and a["n_active"] > 0 for a in segs)
    assert mixed >= 4, segs  # three chunk segments for each of the two later prompts


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunked_transfer_counts_match_jax(qwen, paged):
    """The mixed layouts keep the JAX package's buffer order and join
    protocol (a chunked join re-uploads the control buffers and the
    position leaves only), so one wave served through both servers makes
    the same host-to-device transfers and transfer-cache hits."""
    from repro.core import DeviceGroup as JaxDeviceGroup
    from repro.core import Static as JaxStatic

    jcfg, jp, _, _ = qwen
    cfg, api, params = port_model(qwen)
    prompts = prompts_for(cfg.vocab, 29, 2)
    kw = dict(buckets=(PLEN,), max_batch=2, seg_len=2, max_new_cap=10, max_wait_ms=50.0,
              chunk_len=3)
    with jserve.InferenceServer(jcfg, jax_get_model(jcfg), jp, groups=[JaxDeviceGroup("x")],
                                scheduler=JaxStatic(),
                                paged=jserve.PagedSpec(block_len=4) if paged else None,
                                **kw) as srv:
        want = [h.result(timeout=300) for h in [srv.submit(p, GEN) for p in prompts]]
        jx = srv.stats()["transfers"]["x"]
    with InferenceServer(cfg, api, params, groups=[DeviceGroup("x", device="cpu")],
                         scheduler=Static(), paged=PagedSpec(block_len=4) if paged else None,
                         **kw) as srv:
        got = [h.result(timeout=300) for h in [srv.submit(p, GEN) for p in prompts]]
        tx = srv.stats()["transfers"]["x"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (tx["transfers"], tx["cache_hits"]) == (jx["transfers"], jx["cache_hits"]), (tx, jx)


def test_launcher_chunked_server_verify_on_cpu(capsys):
    from repro_torch.core.trace import Tracer, set_tracer, tracer

    for extra in (["--paged"], []):
        prev = tracer()
        set_tracer(Tracer(capacity=1 << 14, enabled=True))
        try:
            res = launcher.main(["--arch", "qwen1.5-4b", "--server", "--chunk-len", "3",
                                 "--device", "cpu", "--verify", "--requests", "6",
                                 "--prompt-len", "8", "--gen", "4", *extra])
        finally:
            set_tracer(prev)
        out = capsys.readouterr().out
        assert "verify: 6 results bit-identical" in out, out
        assert "chunked prefill: chunk_len 3" in out, out
        assert res["chunk_stages"] >= 3  # ceil(8 / 3) chunks for the first wave
        assert res["stats"]["chunk_len"] == 3


# ----------------------------------------------------------- admission math
def test_ttft_forecast_per_chunk():
    """Chunked TTFT forecast = n_chunks x the segment-rate EMA (no prefill
    term); whole-prompt forecast stays the prefill EMA."""
    adm = DeadlineAdmission()
    assert adm.ttft_forecast(PLEN) is None  # cold
    assert adm.ttft_forecast(PLEN, n_chunks=3) is None
    adm.model.observe("segment", PLEN, 0.010)
    adm.model.observe("prefill", PLEN, 0.200)
    assert adm.ttft_forecast(PLEN) == pytest.approx(0.200)
    assert adm.ttft_forecast(PLEN, n_chunks=3) == pytest.approx(0.030)
    assert adm.ttft_forecast(PLEN, n_chunks=1) == pytest.approx(0.010)


def test_admit_counts_chunks_as_segments():
    """admit(n_chunks=k) forecasts completion as (segments_left + k)
    segments and never adds the prefill EMA."""
    adm = DeadlineAdmission()
    adm.model.observe("segment", PLEN, 0.010)
    adm.model.observe("prefill", PLEN, 10.0)  # would doom any deadline
    now = 100.0
    assert adm.admit(now, now + 0.1, PLEN, 5, n_chunks=3)
    assert not adm.admit(now, now + 0.05, PLEN, 5, n_chunks=3)
    assert not adm.admit(now, now + 0.1, PLEN, 5)


def test_admission_stats_surface():
    adm = DeadlineAdmission()
    adm.model.observe("segment", PLEN, 0.010)
    now = 50.0
    assert adm.admit(now, None, PLEN, 4, n_chunks=2)
    assert not adm.admit(now, now + 0.01, PLEN, 4, n_chunks=2)
    s = adm.stats()
    assert s["admitted"] == 1 and s["rejected"] == 1
    for d in s["decisions"]:
        assert d["bucket"] == PLEN and d["n_chunks"] == 2
        assert d["ttft_forecast_s"] == pytest.approx(0.020)
    assert s["ttft_forecast_mean_s"] == pytest.approx(0.020)


def test_server_forecasts_chunks(qwen):
    """The chunked server passes its chunk count to admission: a deadline
    that fits whole-prompt serving's forecast but not the chunk segments'
    is rejected at submit."""
    cfg, api, params = port_model(qwen)
    adm = DeadlineAdmission()
    adm.model.observe("segment", PLEN, 0.010)
    adm.model.observe("prefill", PLEN, 0.001)
    with InferenceServer(cfg, api, params, groups=[DeviceGroup("adm", device="cpu")],
                         buckets=(PLEN,), seg_len=2, max_new_cap=10, chunk_len=2,
                         admission=adm) as srv:
        # 3 decode segments + 4 chunk segments at 10 ms: 70 ms > 50 ms.
        h = srv.submit(prompts_for(cfg.vocab, 30, 1)[0], GEN, deadline_s=0.05)
        assert h.rejected
    assert adm.stats()["decisions"][-1]["n_chunks"] == chunks_for(PLEN, 2) == 4


@pytest.mark.parametrize("bucket,chunk_len,start,want",
                         [(8, 8, 0, 1), (8, 3, 0, 3), (8, 2, 0, 4), (16, 3, 0, 6),
                          (1, 4, 0, 1), (16, 4, 8, 2), (16, 4, 16, 0)])
def test_chunks_for(bucket, chunk_len, start, want):
    assert chunks_for(bucket, chunk_len, start) == want
    assert jserve.chunks_for(bucket, chunk_len, start) == want


def test_validate_chunked_rejections(qwen):
    cfg, api, params = port_model(qwen)
    with pytest.raises(ValueError, match="chunk_len"):
        validate_chunked(cfg, api, 0)
    with pytest.raises(ValueError, match="window"):
        validate_chunked(dataclasses.replace(cfg, window=4), api, 2)
    with pytest.raises(ValueError, match="family"):
        validate_chunked(cfg, api._replace(prefill_chunk=None), 2)
    with pytest.raises(ValueError, match="cache_dtype"):
        validate_chunked(dataclasses.replace(cfg, cache_dtype="bfloat16"), api, 2)
    with pytest.raises(ValueError, match="seq_shard_cache"):
        validate_chunked(dataclasses.replace(cfg, seq_shard_cache=True), api, 2)
    for arch in ("falcon-mamba-7b", "recurrentgemma-2b"):
        rcfg = tconfigs.reduced(tconfigs.get_config(arch))
        with pytest.raises(ValueError, match="family"):
            validate_chunked(rcfg, get_model(rcfg), 2)
    # The server validates at construction, the draft too when chunking.
    cpu = DeviceGroup("v", device="cpu")
    with pytest.raises(ValueError, match="window"):
        InferenceServer(dataclasses.replace(cfg, window=4), api, params, groups=[cpu],
                        chunk_len=2)
    from repro_torch.serve import DraftSpec

    rcfg = tconfigs.reduced(tconfigs.get_config("recurrentgemma-2b"))
    with pytest.raises(ValueError, match="per-position timeline"):
        InferenceServer(cfg, api, params, groups=[cpu], chunk_len=2,
                        draft=DraftSpec(dataclasses.replace(rcfg, vocab=cfg.vocab), params))


def test_service_model_segment_ema_feeds_chunked_forecast():
    """EMA(alpha=0.4) after 0.010 then 0.020 is 0.014."""
    m = ServiceModel(alpha=0.4)
    m.observe("segment", PLEN, 0.010)
    m.observe("segment", PLEN, 0.020)
    adm = DeadlineAdmission(m)
    assert adm.ttft_forecast(PLEN, n_chunks=2) == pytest.approx(0.028)
