"""The port's MoE family vs the JAX package on the same weights.

JAX parameters from ``materialize(..., PRNGKey(0), float32)`` of reduced
arctic-480b (4 experts, top-2, a dense residual branch) and reduced
kimi-k2-1t-a32b (4 experts, top-2) cross as numpy through
``load_jax_params``.  Held: the MoE FFN with its keep mask *equal* where
capacity binds, lower-index tie-breaking in top-k, top-8 routing over 16
experts, ``moe_gemm_plain`` against the reference's dense einsum, and
prefill, scalar- and vector-position decode, multi-row decode and
``prefill_chunk`` of the whole model, the port's "reference" path against
the JAX "reference" path and the port's "cuda" path (CPU tensors: the
kernels' plain versions) against the JAX "pallas_interpret" path.  Then
the port's server, contiguous and paged, on reduced arctic: its streams
bitwise one-shot generate of the same batch.

Tolerance 1e-4 on float32 outputs: XLA and torch order float32 sums
differently on the CPU.  Routing decisions (expert ids, the keep mask) are
compared exactly."""
import bisect
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import get_model as jax_get_model
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.serve import zeros_cache as jax_zeros_cache
from repro_torch import configs as tconfigs
from repro_torch.core import DeviceGroup, Static
from repro_torch.kernels import moe_gemm as tmoe_gemm
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.serve import make_generate, zeros_cache
from repro_torch.serve import paged as tpaged
from repro_torch.serve.server import InferenceServer

TOL = 1e-4
ARCHS = ["arctic-480b", "kimi-k2-1t-a32b"]
IMPLS = [("reference", "reference"), ("cuda", "pallas_interpret")]


def _weights(arch, **over):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)), **over)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), **over)
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1), jax.random.PRNGKey(0),
                             jnp.float32)
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    return _weights(request.param)


@pytest.fixture(scope="module")
def arctic():
    return _weights("arctic-480b")


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


def _jax_keep(fids, fw, E, C):
    """The reference's keep mask, by its own lines (``_dispatch_compute_combine``)."""
    order = jnp.argsort(fids, stable=True)
    sids = fids[order]
    counts = jnp.bincount(fids, length=E)
    starts = jnp.cumsum(counts) - counts
    pos_sorted = jnp.arange(fids.shape[0], dtype=jnp.int32) - starts[sids].astype(jnp.int32)
    pos_in_e = jnp.zeros(fids.shape[0], jnp.int32).at[order].set(pos_sorted)
    return np.asarray((pos_in_e < C) & (fw != 0))


def _skewed(jp, tp, tcfg):
    """Both trees with router column 0 raised by 0.2, and 48 positive tokens."""
    bump = np.zeros((tcfg.d_model, tcfg.n_experts), np.float32)
    bump[:, 0] = 0.2
    jp = dict(jp, layers=dict(jp["layers"], router=jp["layers"]["router"] + bump))
    tp = dict(tp, layers=dict(tp["layers"],
                              router=tp["layers"]["router"] + torch.from_numpy(bump)))
    x = np.abs(np.random.default_rng(3).standard_normal((48, tcfg.d_model))).astype(np.float32)
    return jp, tp, x


def _ffn_case(jcfg, jp, tcfg, tp, x, impl):
    """(JAX moe_ffn, port moe_ffn, JAX ids, port ids, JAX keep, port keep)
    of layer 0 on tokens x (T, d)."""
    jl, tl = _layer0(jp["layers"]), tparams.tree_map(lambda a: a[0], tp["layers"])
    tcfg = dataclasses.replace(tcfg, kernel_impl=impl)
    E, K = tcfg.n_experts, tcfg.top_k
    C = tmoe.capacity(x.shape[0], tcfg)
    assert C == jmoe.capacity(x.shape[0], jcfg)
    jy = jmoe.moe_ffn(jnp.asarray(x), jl, jcfg)
    ty = tmoe.moe_ffn(torch.from_numpy(x), tl, tcfg)
    jfids, jfw, _ = jmoe._route(jnp.asarray(x), jl["router"], E, K)
    tfids, tfw, ttok = tmoe.route(torch.from_numpy(x), tl["router"], E, K, impl)
    _, tkeep, _, _ = tmoe.dispatch(tfids, tfw, ttok, E, C)
    return (jy, ty, np.asarray(jfids), tfids.numpy(), _jax_keep(jfids, jfw, E, C),
            tkeep.numpy())


@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_moe_ffn_keep_mask_equal_where_capacity_binds(arctic, impl):
    """Positive tokens and a router column raised by 0.2 send every token
    to expert 0 first, so capacity binds at T = 48 (C 32): the keep mask
    drops assignments (16 of expert 0's at least) and equals the
    reference's."""
    jcfg, jp, tcfg, tp = arctic
    jp, tp, x = _skewed(jp, tp, tcfg)
    jy, ty, jids, tids, jkeep, tkeep = _ffn_case(jcfg, jp, tcfg, tp, x, impl)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tkeep, jkeep)
    assert (~tkeep).sum() >= 16, "capacity did not bind"
    _close(ty, jy)


def test_dropped_assignments_are_counted(arctic):
    """The recorder counts a layer call's dropped assignments: every
    assignment the reference's keep mask leaves out (no weight is zero)."""
    jcfg, jp, tcfg, tp = arctic
    jp, tp, x = _skewed(jp, tp, tcfg)
    jfids, jfw, _ = jmoe._route(jnp.asarray(x), _layer0(jp["layers"])["router"], 4, 2)
    want = int((~_jax_keep(jfids, jfw, 4, tmoe.capacity(48, tcfg))).sum())
    tl = tparams.tree_map(lambda a: a[0], tp["layers"])
    x = torch.from_numpy(x)
    with tmoe.dropped_assignments() as drops:
        tmoe.moe_ffn(x, tl, tcfg)
    assert [int(d) for d in drops] == [want] and want >= 16
    with tmoe.dropped_assignments() as drops:
        tmoe.moe_ffn(x[:4], tl, tcfg)  # C 8 >= 4 tokens: nothing drops
    assert [int(d) for d in drops] == [0]


def test_top_k_ties_keep_the_lower_index(arctic):
    """Equal router columns give equal gates: the lower expert index wins,
    as in ``lax.top_k``, through the whole routing."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jcfg, jp, tcfg, _ = arctic
    router = np.asarray(jp["layers"]["router"][0]).copy()
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    x = np.random.default_rng(4).standard_normal((16, tcfg.d_model)).astype(np.float32)
    jids = np.asarray(jmoe._route(jnp.asarray(x), jnp.asarray(router), 4, 2)[0])
    tids = tmoe.route(torch.from_numpy(x), torch.from_numpy(router), 4, 2)[0].numpy()
    np.testing.assert_array_equal(tids, jids)
    # Every token's two experts are a tied pair (0, 2) or (1, 3), lower first.
    assert set(map(tuple, tids.reshape(-1, 2))) <= {(0, 2), (1, 3)}


@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_top8_routing_over_16_experts(impl):
    jcfg, jp, tcfg, tp = _weights("kimi-k2-1t-a32b", n_experts=16, top_k=8)
    x = np.random.default_rng(5).standard_normal((40, tcfg.d_model)).astype(np.float32)
    jy, ty, jids, tids, jkeep, tkeep = _ffn_case(jcfg, jp, tcfg, tp, x, impl)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tkeep, jkeep)
    assert len(set(tids.tolist())) == 16
    _close(ty, jy)


@pytest.mark.parametrize("tokens", [1, 7, 8, 48, 512, 2048])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_is_the_reference(arch, tokens):
    cfg = tconfigs.get_config(arch)
    assert tmoe.capacity(tokens, cfg) == jmoe.capacity(tokens, jconfigs.get_config(arch))


def test_row_map_builds_the_reference_buffer(arctic):
    """The row map and counts of ``dispatch`` make exactly the (E, C, d)
    buffer the reference scatters (``.at[fids, slot].add(x * keep)``),
    where capacity binds."""
    jcfg, jp, tcfg, tp = arctic
    jp, tp, x = _skewed(jp, tp, tcfg)
    E, K, C = 4, 2, tmoe.capacity(48, tcfg)
    jfids, jfw, jtok = jmoe._route(jnp.asarray(x), _layer0(jp["layers"])["router"], E, K)
    keep = jnp.asarray(_jax_keep(jfids, jfw, E, C)).astype(jnp.float32)
    order = jnp.argsort(jfids, stable=True)
    counts = jnp.bincount(jfids, length=E)
    pos_sorted = jnp.arange(jfids.shape[0]) - (jnp.cumsum(counts) - counts)[jfids[order]]
    slot = jnp.minimum(jnp.zeros_like(jfids).at[order].set(pos_sorted), C - 1)
    jbuf = jnp.zeros((E, C, tcfg.d_model)).at[jfids, slot].add(jnp.asarray(x)[jtok]
                                                               * keep[:, None])
    tl = tparams.tree_map(lambda a: a[0], tp["layers"])
    fids, fw, tok = tmoe.route(torch.from_numpy(x), tl["router"], E, K)
    _, _, rows, count = tmoe.dispatch(fids, fw, tok, E, C)
    buf = tmoe_gemm.capacity_buffer(torch.from_numpy(x), count, rows)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert count.tolist() == np.minimum(np.asarray(counts), C).tolist()


def test_materialize_draws_large_leaves_by_slices(monkeypatch):
    """A leaf past ``DRAW_SLICE`` elements is drawn that many at a time, in
    row-major order, from the same generator and distribution."""
    monkeypatch.setattr(tparams, "DRAW_SLICE", 1000)
    spec = {"big": tparams.Spec((3, 2, 20, 30)), "small": tparams.Spec((20, 25))}
    got = tparams.materialize(spec, torch.Generator().manual_seed(4), torch.float32, "cpu")
    g = torch.Generator().manual_seed(4)
    want = torch.cat([torch.randn(m, generator=g) for m in (1000,) * 3 + (600,)])
    want = want.view(3, 2, 20, 30)
    torch.testing.assert_close(got["big"], want * 20 ** -0.5, rtol=0, atol=0)
    torch.testing.assert_close(got["small"], torch.randn((20, 25), generator=g) * 20 ** -0.5,
                               rtol=0, atol=0)


@pytest.mark.parametrize("rows", [False, True], ids=["buffer", "row map"])
def test_moe_gemm_plain_is_the_reference_einsum(rows):
    """``moe_gemm_plain`` (and its fused gate/up form) against the JAX
    package's dense einsums over the capacity buffer the reference builds."""
    rng = np.random.default_rng(6)
    E, C, T, K, N = 4, 8, 10, 24, 16
    x = rng.standard_normal((T, K)).astype(np.float32)
    w, wu = (rng.standard_normal((E, K, N)).astype(np.float32) for _ in range(2))
    rmap = np.full((E, C), -1, np.int32)
    count = np.array([3, 0, 8, 5], np.int32)
    for e in range(E):
        rmap[e, :count[e]] = rng.integers(0, T, count[e])
    rmap[2, 4] = -1  # a zero row inside the filled ones (a zero-weight assignment)
    buf = np.where((rmap >= 0)[..., None], x[np.maximum(rmap, 0)], 0).astype(np.float32)
    jy = jnp.einsum("ecd,edf->ecf", buf, w)
    jh = jax.nn.silu(jy) * jnp.einsum("ecd,edf->ecf", buf, wu)
    args = ((torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(count),
             torch.from_numpy(rmap)) if rows else
            (torch.from_numpy(buf), torch.from_numpy(w), torch.from_numpy(count)))
    _close(tmoe_gemm.moe_gemm_plain(*args), jy)
    _close(tmoe_gemm.moe_gemm(*args, w_up=torch.from_numpy(wu)), jh)


def _both(weights, impls):
    jcfg, jp, tcfg, tp = weights
    jcfg = dataclasses.replace(jcfg, kernel_impl=impls[1])
    tcfg = dataclasses.replace(tcfg, kernel_impl=impls[0])
    return jcfg, jax_get_model(jcfg), jp, tcfg, get_model(tcfg), tp


@pytest.mark.parametrize("impls", IMPLS, ids=[i[0] for i in IMPLS])
def test_model_paths_match(weights, impls):
    jcfg, japi, jp, tcfg, tapi, tp = _both(weights, impls)
    b, s, max_seq = 3, 8, 20
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    jcache = jax_zeros_cache(jcfg, japi, b, max_seq)
    tcache = zeros_cache(tcfg, tapi, b, max_seq, device="cpu")
    jl, jcache = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jcache)
    tl, tcache = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tcache)
    _close(tl, jl)
    _close(tcache["k"], jcache["k"])

    tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.int32(s), jcfg, jcache)
    tl, tcache = tapi.decode(tp, torch.from_numpy(tok), s, tcfg, tcache)
    _close(tl, jl)

    posv = np.asarray([5, s + 1, 3], np.int32)
    tok = rng.integers(0, tcfg.vocab, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.asarray(posv), jcfg, jcache)
    tl, tcache = tapi.decode(tp, torch.from_numpy(tok), torch.from_numpy(posv), tcfg, tcache)
    _close(tl, jl)

    posv = np.asarray([6, s + 2, 4], np.int32)
    tok = rng.integers(0, tcfg.vocab, (b, 3)).astype(np.int32)
    jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.asarray(posv), jcfg, jcache)
    tl, tcache = tapi.decode(tp, torch.from_numpy(tok), torch.from_numpy(posv), tcfg, tcache)
    _close(tl, jl)
    _close(tcache["v"], jcache["v"])
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("impls", IMPLS, ids=[i[0] for i in IMPLS])
def test_prefill_chunk_matches(weights, impls):
    """Mixed-phase chunks: slot 0 prefilling from 0, slot 1 from 4, slot 2
    decoding (all rows masked), two chunks of 4."""
    jcfg, japi, jp, tcfg, tapi, tp = _both(weights, impls)
    b, bucket, L, max_seq = 3, 8, 4, 16
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (b, bucket)).astype(np.int32)
    jcache = jax_zeros_cache(jcfg, japi, b, max_seq)
    tcache = zeros_cache(tcfg, tapi, b, max_seq, device="cpu")
    cur = np.array([0, 4, bucket], np.int32)
    for _ in range(2):
        positions = cur[:, None] + np.arange(L, dtype=np.int32)
        valid = positions < bucket
        chunk = np.take_along_axis(toks, np.clip(positions, 0, bucket - 1), axis=1)
        last = np.clip(bucket - 1 - cur, 0, L - 1).astype(np.int32)
        jl, jcache = japi.prefill_chunk(jp, jnp.asarray(chunk), jnp.asarray(cur),
                                        jnp.asarray(valid), jcfg, jcache, jnp.asarray(last))
        tl, tcache = tapi.prefill_chunk(tp, torch.from_numpy(chunk), torch.from_numpy(cur),
                                        torch.from_numpy(valid), tcfg, tcache,
                                        torch.from_numpy(last))
        _close(tl, jl)
        cur = np.minimum(cur + L, bucket)
    _close(tcache["k"], jcache["k"])
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_server_streams_equal_one_shot_of_the_batch(arctic, impl, paged):
    """Four prompts board in one prefill wave (capacity set by that wave's
    tokens, as one-shot generate's); every stream is bitwise one-shot
    generate of the same batch of four, and, where no call dropped an
    assignment, of its prompt alone."""
    _, _, tcfg, tp = arctic
    cfg = dataclasses.replace(tcfg, kernel_impl=impl,
                              decode_block=4 if impl == "cuda" and paged else 0)
    api = get_model(cfg)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, 8).astype(np.int32) for _ in range(4)]
    gen = 6
    with InferenceServer(cfg, api, tp, groups=[DeviceGroup(f"moe-{impl}-{paged}", device="cpu")],
                         scheduler=Static(), buckets=(8,), max_batch=4, seg_len=2,
                         max_new_cap=gen, max_wait_ms=500.0,
                         paged=tpaged.PagedSpec(block_len=4) if paged else None) as srv:
        handles = [srv.submit(p, gen) for p in prompts]
        served = [h.result(timeout=300) for h in handles]
        assert srv.stats()["prefill_waves"] == 1
    generate = make_generate(cfg, api)
    with tmoe.dropped_assignments() as drops:
        want = generate(tp, {"tokens": torch.from_numpy(np.stack(prompts))}, gen).numpy()
        alone = [generate(tp, {"tokens": torch.from_numpy(p[None])}, gen)[0].numpy()
                 for p in prompts]
    for got, w in zip(served, want):
        np.testing.assert_array_equal(got, w)
    assert len(drops) == 2 * (1 + 4) * gen  # two layers a forward, gen forwards a call
    if not any(int(d) for d in drops):
        for got, a in zip(served, alone):
            np.testing.assert_array_equal(got, a)


# ---- moe_gemm's launch plan and tile walk (pure: no card) ----

@pytest.mark.parametrize("fused", [True, False], ids=["gate-up", "down"])
def test_moe_gemm_plan_follows_the_shape_alone(fused):
    """The tile and stages follow ``fused`` alone, at every C, K, N and E
    (decode's C 8 takes prefill's tile); the grid is one wave, at most one
    block an SM of the card and at most the tiles a call could fill.  The
    counts never reach the plan."""
    bn = tmoe_gemm.PART if fused else 2 * tmoe_gemm.PART
    for C in (8, 16, 24, 48, 56, 64, 128):
        for K, N in ((7168, 4864), (4864, 7168), (7168, 2048), (2048, 7168), (24, 16)):
            for E in (1, 4, 128, 384):
                for sms in (132, 114, 78):
                    p = tmoe_gemm.plan(E, C, K, N, fused, sms)
                    assert p.tile == (tmoe_gemm.BM, bn, tmoe_gemm.BK) == (64, bn, 64)
                    assert p.stages == tmoe_gemm.STAGES == 5
                    most = E * -(-C // 64) * -(-N // bn)
                    assert p.blocks == min(sms, most)
    assert tmoe_gemm.plan(128, 8, 4864, 7168, False, 132).blocks == 132   # arctic decode down
    assert tmoe_gemm.plan(4, 8, 24, 16, fused, 132).blocks == 4


@pytest.mark.parametrize("K", [16, 24, 2048, 4864, 7168, 7176])
def test_moe_gemm_chain_follows_K_alone(K):
    """At every C, E, N, card and both forms, one chain of ceil(K/16) k16
    steps with no split: what keeps a row's bits whatever C or the other
    rows of its tile, and equal to ``gemm_rowinv``'s chain of the same
    K."""
    from repro_torch.kernels import gemm

    chains = {tmoe_gemm.plan(E, C, K, 4096, fused, sms).chain
              for E in (4, 128, 384) for C in (8, 16, 48, 200) for fused in (True, False)
              for sms in (132, 78)}
    assert chains == {("k16", -(-K // 16), 1)}
    assert chains == {gemm.plan(m, 4096, K, 0, True).chain for m in (1, 8, 300)}


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


# Operands the kernel does not take, each refused before a build or launch.
BAD_OPERANDS = {
    "float32": (lambda: (torch.zeros(3, 8, 16), torch.zeros(3, 16, 24),
                         torch.tensor([2, 0, 8], dtype=torch.int32)), TypeError),
    "experts past MAX_E": (lambda: (_bf16(513, 8, 16), _bf16(513, 16, 24),
                                    torch.zeros(513, dtype=torch.int32)), ValueError),
    "int64 count": (lambda: (_bf16(3, 8, 16), _bf16(3, 16, 24),
                             torch.tensor([2, 0, 8])), ValueError),
    "row map of another E": (lambda: (_bf16(5, 16), _bf16(3, 16, 24),
                                      torch.zeros(3, dtype=torch.int32),
                                      torch.zeros(4, 8, dtype=torch.int32)), ValueError),
    "buffer of another K": (lambda: (_bf16(3, 8, 32), _bf16(3, 16, 24),
                                     torch.zeros(3, dtype=torch.int32)), ValueError),
    "K not a multiple of 8": (lambda: (_bf16(3, 8, 12), _bf16(3, 12, 24),
                                       torch.zeros(3, dtype=torch.int32)), ValueError),
}


@pytest.mark.parametrize("case", list(BAD_OPERANDS))
def test_moe_gemm_refuses_operands_the_kernel_does_not_take(case):
    """The CUDA wrapper's checks, which run before the kernel is built or
    launched: bfloat16 only, at most ``MAX_E`` experts (the kernel's
    shared-memory count table), int32 counts of (E,), a row map of (E, C),
    the buffer's K that of the weights, K and N multiples of 8.  A tensor
    on a device other than cuda or cpu is refused by ``moe_gemm`` itself."""
    make, err = BAD_OPERANDS[case]
    with pytest.raises(err):
        tmoe_gemm._moe_gemm_cuda(*make(), *[None] * (5 - len(make())))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tmoe_gemm.moe_gemm(*[t.to("meta") for t in make()])


def _counts(rng, E, C):
    """Per-expert counts with empty experts, full ones and everything
    between (and counts past C, which the kernel clamps)."""
    kind = rng.integers(0, 4, E)
    cnt = np.where(kind == 0, 0, np.where(kind == 1, C, rng.integers(0, C + 1, E)))
    cnt[rng.integers(0, E)] = C + 5
    return cnt.astype(np.int32)


def _walk(count, C, N, p, blocks):
    """A model of the walk ``csrc/moe_gemm.cu`` documents: for each of
    ``blocks`` blocks, the tiles (expert, first row, first column) it
    computes, in order.  Row tiles are ``ceil(min(count[e], C) / BM)`` an
    expert, prefix-summed; tile t is the (t // tiles_n)-th filled row tile,
    column tile t % tiles_n; block b takes t = b, b + blocks, ..."""
    bm, bn, _ = p.tile
    pre = [0]
    for c in count:
        pre.append(pre[-1] + -(-min(max(int(c), 0), C) // bm))
    tiles_n = -(-N // bn)
    out = []
    for b in range(blocks):
        mine = []
        for t in range(b, pre[-1] * tiles_n, blocks):
            u, nt = divmod(t, tiles_n)
            e = bisect.bisect_right(pre, u) - 1
            mine.append((e, (u - pre[e]) * bm, nt * bn))
        out.append(mine)
    return out


@pytest.mark.parametrize("E,C,N", [(4, 8, 24), (128, 8, 7168), (128, 48, 4864),
                                   (384, 56, 7168), (384, 8, 2048), (16, 200, 256)])
def test_moe_gemm_walk_visits_every_filled_tile_once(E, C, N):
    """The walk's scheme, as a model (``_walk``; the card's rel. L2 and
    rows-past-count checks in chip_smoke.py cover the kernel itself):
    under the plan's tile, fused or not, at the plan's grid and at other
    block counts, it visits every filled (expert, row tile, column tile)
    exactly once and no empty one; the epilogues' rows and the zero store
    loop's (every row from an expert's first unfilled row tile on) cover
    each of the E x C rows exactly once."""
    rng = np.random.default_rng(E * 1000 + C)
    for trial in range(3):
        cnt = _counts(rng, E, C)
        for fused in (True, False):
            p = tmoe_gemm.plan(E, C, 7168, N, fused, 132)
            bm, bn, _ = p.tile
            filled = {(e, m0, n0) for e in range(E)
                      for m0 in range(0, min(int(cnt[e]), C), bm)
                      for n0 in range(0, N, bn)}
            for blocks in {p.blocks, 1, 7, 264}:
                walk = _walk(cnt, C, N, p, blocks)
                assert len(walk) == blocks
                seen = [t for mine in walk for t in mine]
                assert len(seen) == len(set(seen)) and set(seen) == filled
                for mine in walk:  # each block in ascending tile order
                    assert mine == sorted(mine)
            rows = np.zeros((E, C), np.int32)
            for e, m0, _ in {(e, m0, 0) for e, m0, _ in filled}:
                rows[e, m0:m0 + bm] += 1
            for e in range(E):  # the store loop: rows past the filled tiles
                rows[e, min(-(-min(int(cnt[e]), C) // bm) * bm, C):] += 1
            assert (rows == 1).all()
