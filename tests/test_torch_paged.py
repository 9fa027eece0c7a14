"""The port's paged continuous-batching server vs the JAX package: ports of
tests/test_paged.py on reduced qwen1.5-4b (float32, weights materialized in
JAX and loaded with ``load_jax_params``).

Every served stream is held bitwise against the port's own one-shot
``make_generate`` of its prompt at batch 1 (the server's contract, as in
the JAX suite) and against the JAX package's one-shot tokens on the same
weights; under ``kernel_impl="cuda"`` the paged decode runs
``flash_decode_paged``'s plain version and the one-shot reference tiles its
cache at the block length (``decode_block``).  Pool bookkeeping
(``BlockPool``, ``PoolAdmission``, ``blocks_needed``) is held number for
number against the JAX functions."""
import dataclasses
import math
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.core import DeviceGroup, Static
from repro_torch.launch import serve as launcher
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import DraftSpec, make_generate
from repro_torch.serve import paged as tpaged
from repro_torch.serve.admission import PoolAdmission
from repro_torch.serve.server import AdmissionError, InferenceServer

PLEN = 8
IMPLS = ["reference", "cuda"]


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX params, port float32 params on the CPU)."""
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen1.5-4b"))
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1),
                             jax.random.PRNGKey(0), jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get_config("qwen1.5-4b"))
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tp


@pytest.fixture(scope="module")
def jax_reference(weights):
    """JAX one-shot tokens of one prompt (batch 1), memoized."""
    jcfg, jp, _ = weights
    gen = jserve.make_generate(jcfg, jax_get_model(jcfg))
    memo = {}

    def ref(prompt, n):
        key = (np.asarray(prompt).tobytes(), n)
        if key not in memo:
            memo[key] = np.asarray(gen(jp, {"tokens": jnp.asarray(np.asarray(prompt)[None])},
                                       n))[0]
        return memo[key]

    return ref


def port_model(weights, impl, block_len=4, **over):
    """(cfg, api, params) of the port; under "cuda" the one-shot reference
    tiles its cache at the pool's block length."""
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("qwen1.5-4b")),
                              kernel_impl=impl,
                              decode_block=block_len if impl == "cuda" else 0, **over)
    return cfg, get_model(cfg), weights[2]


def check_streams(cfg, api, params, prompts, gens, results, jax_reference=None):
    """Each served stream equals the port's one-shot generate of its prompt
    at batch 1, bitwise (and the JAX package's tokens, when given)."""
    gen = make_generate(cfg, api)
    for p, n, got in zip(prompts, gens, results):
        want = gen(params, {"tokens": torch.from_numpy(p[None])}, n)[0].numpy()
        np.testing.assert_array_equal(got, want)
        if jax_reference is not None:
            np.testing.assert_array_equal(got, jax_reference(p, n))


def prompts_for(vocab, seed, n, plen=PLEN):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen).astype(np.int32) for _ in range(n)]


def paged_server(cfg, api, params, *, name, block_len=4, n_blocks=0,
                 prefix=True, max_batch=4, seg_len=2, max_new_cap=8,
                 max_wait_ms=5.0, buckets=(PLEN,)):
    return InferenceServer(
        cfg, api, params, groups=[DeviceGroup(name, device="cpu")], scheduler=Static(),
        buckets=buckets, max_batch=max_batch, seg_len=seg_len,
        max_new_cap=max_new_cap, max_wait_ms=max_wait_ms,
        paged=tpaged.PagedSpec(block_len=block_len, n_blocks=n_blocks,
                               prefix_cache=prefix),
    )


# ------------------------------------------------------------ acceptance run
@pytest.mark.parametrize("impl", IMPLS)
def test_join_exit_sweep_bit_identical_with_block_reuse(weights, jax_reference, impl):
    """Staggered joins/exits with mixed gen lengths through the paged pool:
    every stream equals its one-shot references regardless of which
    physical blocks back it, and exits really recycle blocks."""
    cfg, api, params = port_model(weights, impl)
    prompts = prompts_for(cfg.vocab, 11, 16)
    gens = [4 + (i % 3) for i in range(16)]
    gaps = np.random.default_rng(12).exponential(3e-3, 16)
    with paged_server(cfg, api, params, name="sweep") as srv:
        handles = []
        for p, n, gap in zip(prompts, gens, gaps):
            time.sleep(gap)
            handles.append(srv.submit(p, n))
        results = [h.result(timeout=300) for h in handles]
        s = srv.stats()
    check_streams(cfg, api, params, prompts, gens, results, jax_reference)
    mem = s["memory"]
    assert s["completed"] == 16 and s["failed"] == 0
    assert mem["frees"] > 0, mem
    assert mem["allocs"] > mem["blocks_peak"], mem  # blocks were reused
    assert mem["kv_bytes_allocated"] == mem["blocks_peak"] * mem["bytes_per_block"]


# ------------------------------------------------------------- prefix reuse
@pytest.mark.parametrize("impl", IMPLS)
def test_same_wave_prefix_share_and_cow_divergence(weights, jax_reference, impl):
    """Two identical prompts in one wave with a partial tail block: prefill
    runs once, both slots share the blocks, and the first divergent append
    is isolated by copy-on-write."""
    cfg, api, params = port_model(weights, impl, block_len=16)
    p = prompts_for(cfg.vocab, 21, 1)[0]
    with paged_server(cfg, api, params, name="cow", block_len=16, max_wait_ms=50.0) as srv:
        h1 = srv.submit(p, 6)
        h2 = srv.submit(p.copy(), 3)
        r1, r2 = h1.result(timeout=300), h2.result(timeout=300)
        mem = srv.stats()["memory"]
    check_streams(cfg, api, params, [p, p], [6, 3], [r1, r2], jax_reference)
    assert mem["prefill_rows"] == 1, mem      # one prefill for two requests
    assert mem["prefix_hits"] >= 1, mem
    assert mem["cow"] >= 1, mem               # tail block copied on divergence


def test_cross_wave_prompt_reuse_and_chain_share(weights, jax_reference):
    """The prefix cache survives request exit and group dissolve: a repeated
    whole prompt skips prefill; a prompt sharing only the first full block
    maps its leading table entry to the same physical block."""
    cfg, api, params = port_model(weights, "cuda")
    p1 = prompts_for(cfg.vocab, 31, 1)[0]
    p2 = p1.copy()
    p2[4:] = prompts_for(cfg.vocab, 32, 1)[0][4:]
    with paged_server(cfg, api, params, name="pfx", max_wait_ms=2.0) as srv:
        ra = srv.submit(p1, 4).result(timeout=300)
        time.sleep(0.05)  # first group goes idle and dissolves
        hb, hc = srv.submit(p1.copy(), 6), srv.submit(p2, 4)
        rb, rc = hb.result(timeout=300), hc.result(timeout=300)
        mem = srv.stats()["memory"]
    check_streams(cfg, api, params, [p1, p1, p2], [4, 6, 4], [ra, rb, rc], jax_reference)
    assert mem["prefill_rows_shared"] >= 1, mem  # whole-prompt hit: no prefill
    assert mem["prefix_blocks_shared"] >= 1, mem  # chain hit: shared block
    assert mem["blocks_cached"] > 0, mem


# ---------------------------------------------------------------- admission
def test_pool_exhaustion_defers_then_serves(weights, jax_reference):
    """A pool too small for the offered concurrency defers boardings until
    exits free blocks; every request completes correctly."""
    cfg, api, params = port_model(weights, "cuda")
    prompts = prompts_for(cfg.vocab, 41, 5)
    with paged_server(cfg, api, params, name="exh", n_blocks=10, prefix=False,
                      max_wait_ms=2.0) as srv:
        handles = [srv.submit(p, 6) for p in prompts]
        results = [h.result(timeout=300) for h in handles]
        s = srv.stats()
    check_streams(cfg, api, params, prompts, [6] * 5, results, jax_reference)
    assert s["completed"] == 5
    assert s["deferred"] >= 1, s


def test_oversize_request_rejected_at_submit(weights):
    cfg, api, params = port_model(weights, "cuda")
    with paged_server(cfg, api, params, name="rej", n_blocks=5, max_batch=2,
                      max_new_cap=16) as srv:
        h = srv.submit(prompts_for(cfg.vocab, 51, 1)[0], 16)
        assert h.done() and h.rejected
        with pytest.raises(AdmissionError, match="blocks"):
            h.result()
        assert srv.stats()["rejected"] == 1


def test_paged_config_validation(weights):
    cfg, api, params = port_model(weights, "reference")
    cpu = lambda n: DeviceGroup(n, device="cpu")  # noqa: E731
    # Multi-group paged serving is ported: one pool per group by default;
    # a single pool across groups cannot be slot-split.
    with InferenceServer(cfg, api, params, paged=tpaged.PagedSpec(),
                         groups=[cpu("a"), cpu("b")], buckets=(PLEN,)) as srv:
        assert srv.group_batches
        assert srv.stats()["placement"]["member_slots"] == {"a": 2, "b": 2}
    with pytest.raises(ValueError, match="group_batches"):
        InferenceServer(cfg, api, params, paged=tpaged.PagedSpec(),
                        groups=[cpu("a"), cpu("b")], group_batches=False)
    # Chunked prefill is ported: chunk_len is validated, not refused.
    with InferenceServer(cfg, api, params, groups=[cpu("a")], chunk_len=4) as srv:
        assert srv.stats()["chunk_len"] == 4
    with pytest.raises(ValueError, match="chunk_len"):
        InferenceServer(cfg, api, params, groups=[cpu("a")], chunk_len=-1)
    # Speculative serving is ported: the draft is validated, not refused.
    with pytest.raises(ValueError, match="rolling window"):
        InferenceServer(cfg, api, params, groups=[cpu("a")],
                        draft=DraftSpec(dataclasses.replace(cfg, window=8), params))
    srv = InferenceServer(cfg, api, params, paged=tpaged.PagedSpec(), groups=[cpu("a")],
                          buckets=(PLEN,))
    srv.close()
    kcfg = dataclasses.replace(cfg, kernel_impl="cuda")
    with pytest.raises(ValueError, match="decode_block"):
        InferenceServer(kcfg, api, params, paged=tpaged.PagedSpec(block_len=4),
                        groups=[cpu("a")])
    # The default group is cuda:0: without CUDA the server refuses.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceServer(cfg, api, params, paged=tpaged.PagedSpec())


def test_pool_admission_and_blocks_needed_units():
    adm = PoolAdmission()
    jadm = jserve.PoolAdmission()
    for need, cap in [(4, 4), (5, 4), (2, 2.0), (3, 2.0), (10**9, math.inf)]:
        assert adm.admit_submit(need, cap) == jadm.admit_submit(need, cap)
        assert adm.admit_board(need, cap) == jadm.admit_board(need, cap)
    assert adm.admit_board(10**9, math.inf)  # contiguous: never defers
    cases = [((8, 1, 2, 4), {}), ((8, 6, 2, 4), {}), ((8, 6, 2, 16), {}),
             ((8, 6, 2, 4), {"window": 8, "max_seq": 14}),
             ((256, 32, 8, 16), {}), ((300, 7, 3, 16), {})]
    for args, kw in cases:
        assert tpaged.blocks_needed(*args, **kw) == jserve.blocks_needed(*args, **kw)
    assert [tpaged.blocks_needed(*a, **k) for a, k in cases[:4]] == [2, 4, 1, 2]
    from repro.serve import paged as jpaged

    for bl, max_seq, window in [(4, 14, 0), (16, 288, 0), (4, 16, 8), (16, 300, 0)]:
        assert tpaged.table_width(bl, max_seq, window) == jpaged.table_width(bl, max_seq,
                                                                              window)
        for n_slots in (1, 3, 8):
            spec, jspec = tpaged.PagedSpec(block_len=bl), jpaged.PagedSpec(block_len=bl)
            assert (tpaged.pool_capacity(spec, n_slots, max_seq, window)
                    == jpaged.pool_capacity(jspec, n_slots, max_seq, window))
    # The main path's pool on the card: 8 slots of 288 positions in blocks
    # of 16 -> 18 table entries, 2 + 8 * 18 = 146 blocks rounded up to 152.
    assert tpaged.pool_blocks(tpaged.PagedSpec(block_len=16), 8, 18) == 152


def _pool_script(pool):
    """One sequence of allocator operations; returns what it observed."""
    seen = []
    a = pool.alloc(3)
    seen.append((a, pool.in_use, pool.free_count))
    pool.incref([a[0]])
    pool.release(a)
    seen.append(pool.in_use)
    pool.release([a[0]])
    seen.append((pool.in_use, pool.peak_in_use))
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(7)
    b = pool.alloc(2)
    pool.register_prompt(b"p1", b, 7)
    pool.release(b)  # request exits; the cache pin keeps them
    seen.append((pool.in_use, pool.reclaimable(), pool.lookup_prompt(b"p1")))
    key = pool.chain_key(("root",), np.arange(4, dtype=np.int32))
    d = pool.alloc(1)
    pool.register_chain(key, d[0])
    seen.append((pool.lookup_chain(key), pool.stats()))
    pool.release(d)
    c = pool.alloc(5)  # forces eviction of the cached blocks
    seen.append((c, pool.lookup_prompt(b"p1"), pool.lookup_chain(key), pool.stats()))
    pool.release(c)
    seen.append(pool.stats())
    return seen


def test_block_pool_units_match_reference():
    got = _pool_script(tpaged.BlockPool(8, block_len=4, bytes_per_block=100))
    want = _pool_script(jserve.BlockPool(8, block_len=4, bytes_per_block=100))
    assert repr(got) == repr(want)
    assert got[3][0] == 2 and got[3][1] == 2 and got[-2][1] is None


# ----------------------------------------------------------- memory metrics
def test_paged_allocated_bytes_strictly_below_contiguous(weights, jax_reference):
    """Equal load and geometry, max_new_cap above the replayed gen: the
    contiguous layout allocates every slot at capacity, the pool allocates
    recorded depth."""
    cfg, api, params = port_model(weights, "cuda")
    prompts = prompts_for(cfg.vocab, 61, 6)

    def run(paged):
        srv = InferenceServer(
            cfg, api, params, groups=[DeviceGroup("memA" if paged else "memB", device="cpu")],
            scheduler=Static(), buckets=(PLEN,), max_batch=4, seg_len=2,
            max_new_cap=12, max_wait_ms=5.0,
            paged=tpaged.PagedSpec(block_len=4) if paged else None,
        )
        with srv:
            handles = [srv.submit(p, 6) for p in prompts]
            results = [h.result(timeout=300) for h in handles]
            check_streams(cfg, api, params, prompts, [6] * 6, results, jax_reference)
            return srv.stats()["memory"]

    paged = run(True)
    contiguous = run(False)
    assert contiguous["mode"] == "contiguous" and paged["mode"] == "paged"
    assert paged["kv_bytes_allocated"] < contiguous["kv_bytes_allocated"], (paged, contiguous)
    assert paged["kv_bytes_touched"] > 0 and contiguous["kv_bytes_touched"] > 0


def test_metrics_and_steady_state_transfers(weights):
    """metrics() reports pool utilization and per-group transfers; a lone
    request's decode segments after the first are served device-resident
    (the pool leaves are uploaded once per join, not per segment)."""
    cfg, api, params = port_model(weights, "cuda")
    p = prompts_for(cfg.vocab, 81, 1)[0]
    with paged_server(cfg, api, params, name="met", max_new_cap=12) as srv:
        srv.submit(p, 12).result(timeout=300)  # 1 prefill + 6 segments
        m = srv.metrics()
        s = srv.stats()
    for key in ("blocks_in_use", "blocks_free", "blocks_peak", "prefix_hits",
                "cow", "kv_bytes_allocated", "kv_bytes_touched"):
        assert key in m["memory"], (key, m["memory"])
    assert m["memory"]["blocks_free"] > 0
    assert s["segments"] == 6 and s["prefill_waves"] == 1
    # Uploads: the prompt (1); the first segment's tok, pos, table and 3
    # pool leaves (6); the table again after the exit re-points it at the
    # sink (none: the group dissolves).  Later segments hit the cache.
    t = m["groups"]["met"]
    assert t["transfers"] == 7, t
    assert t["cache_hits"] == 5 * 6, t


# ------------------------------------------------------- rolling-window mode
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_rolling_window_through_server(weights, paged):
    """Rolling (sliding-window) caches through the server decode path, both
    memory layouts, equal to one-shot generate on the same windowed config
    (reused slots decode over wrapped rings)."""
    cfg, api, params = port_model(weights, "cuda", window=8)
    prompts = prompts_for(cfg.vocab, 91, 5)
    spec = tpaged.PagedSpec(block_len=4) if paged else None
    with InferenceServer(cfg, api, params, groups=[DeviceGroup(f"win{paged}", device="cpu")],
                         scheduler=Static(), buckets=(PLEN,), max_batch=2,
                         seg_len=2, max_new_cap=8, max_wait_ms=2.0, paged=spec) as srv:
        handles = [srv.submit(p, 6) for p in prompts]
        results = [h.result(timeout=300) for h in handles]
        s = srv.stats()
    assert s["completed"] == 5
    check_streams(cfg, api, params, prompts, [6] * 5, results)
    if paged:
        assert s["memory"]["mode"] == "paged"
        assert s["memory"]["blocks_cached"] == 0  # no prefix sharing on rings


# ----------------------------------------------------------------- launcher
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_launcher_server_verify_on_cpu(paged, capsys):
    """``--server [--paged] --device cpu --verify`` on the reduced config:
    the launcher serves every request and checks each stream against
    one-shot generate."""
    argv = ["--arch", "qwen1.5-4b", "--server", "--device", "cpu", "--verify",
            "--requests", "6", "--prompt-len", "8", "--gen", "5", "--rate", "500",
            "--max-batch", "4", "--seg-len", "2", "--block-len", "4"]
    out = launcher.main(argv + (["--paged"] if paged else []))
    text = capsys.readouterr().out
    assert "served 6/6 requests on cpu" in text and "0 failed" in text
    assert "verify: 6 results bit-identical to one-shot generate" in text
    assert ("paged KV: peak" in text) == paged
    assert out["stats"]["completed"] == 6
    assert all(r.shape == (5,) for r in out["results"])
