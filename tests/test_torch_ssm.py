"""The port's ssm family and its two scan kernels vs the JAX package.

- The plain versions of ``ssm_scan`` and ``rglru_scan`` (CPU tensors) and
  the port's oracles against the JAX Pallas kernels in interpret mode and
  the JAX oracles, on the cases of tests/test_kernels.py plus ssm cases
  whose di is not a multiple of 32 and whose N is 1 and 32, the kernel's
  smallest and largest state.  Tolerance 1e-4 (atol and rtol), that
  suite's own.
- ``scan_plan``, the CUDA kernel's launch in Python: every channel in
  exactly one block, N padded to the kernel's instances, refusals before
  any launch, shared bytes that fit four blocks an SM and mirror the
  source's constants, the grid at the main paths' widths, and a channel's
  arithmetic (the kernel instance) independent of B.
- Reduced falcon-mamba-7b, JAX parameters loaded with ``load_jax_params``:
  prefill, scalar- and vector-position decode logits and the ssm cache in
  float32 at 1e-4 (XLA and torch order float32 sums differently).  A
  256-token prompt reaches the scan kernel (the plain version on the CPU)
  in both packages; 12 tokens take the token-by-token scan in the JAX
  package and the kernel's wrapper under the port's "cuda".  The port's
  "reference" is held against the JAX "reference", the port's "cuda"
  against the JAX "pallas_interpret".
- The port's "cuda" sends every prefill of S > 1 to the ``ssm_scan``
  wrapper, one call per layer, and agrees with its "reference" at 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.ops import rglru_scan as jax_rglru_scan
from repro.kernels.ops import ssm_scan as jax_ssm_scan
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro.serve import zeros_cache as jax_zeros_cache
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import ssm_scan as tss
from repro_torch.kernels.ops import launch_counts, reset_launch_counts
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import zeros_cache

TOL = 1e-4
IMPLS = [("reference", "reference"), ("cuda", "pallas_interpret")]


def _jitted(api):
    """The JAX model's prefill and decode under ``jax.jit`` (config
    static): op-by-op dispatch of the recurrent stacks costs many seconds a
    call on the CPU."""
    return api._replace(prefill=jax.jit(api.prefill, static_argnums=2),
                        decode=jax.jit(api.decode, static_argnums=3))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol, rtol=tol)


def ssm_inputs(seed, b, s, di, n):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(b, s, di)))  # softplus
    return dt, f(b, s, di), f(b, s, n), f(b, s, n), -np.exp(f(di, n) * 0.5), f(b, di, n)


# b, s, di, n, chunk, block_d: tests/test_kernels.py's cases, then di = 40
SSM_CASES = [(1, 64, 32, 8, 32, 32), (2, 128, 64, 16, 32, 16), (1, 256, 128, 8, 64, 128),
             (2, 64, 40, 8, 32, 40), (2, 64, 40, 1, 32, 40), (1, 64, 32, 32, 32, 32)]


@pytest.mark.parametrize("b,s,di,n,chunk,bd", SSM_CASES)
def test_ssm_scan_plain_matches_jax(b, s, di, n, chunk, bd):
    ins = ssm_inputs(b * s + di, b, s, di, n)
    want = jax_ssm_scan(*map(jnp.asarray, ins), chunk=chunk, block_d=bd, interpret=True)
    oracle = jref.ssm_scan_ref(*map(jnp.asarray, ins))
    reset_launch_counts()
    got = tss.ssm_scan(*map(torch.from_numpy, ins))
    tor = tref.ssm_scan_ref(*map(torch.from_numpy, ins))
    assert launch_counts()["ssm_scan"] == 0  # CPU tensors: the plain version
    for g, w, t, o in zip(got, want, tor, oracle):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w)
        _close(g, o)
        _close(t, o)


@pytest.mark.parametrize("b,s,w,chunk,bw", [(1, 64, 32, 32, 32), (2, 128, 64, 64, 32),
                                            (3, 96, 48, 32, 16)])
def test_rglru_scan_plain_matches_jax(b, s, w, chunk, bw):
    rng = np.random.default_rng(b * s + w)
    a = 1 / (1 + np.exp(-rng.standard_normal((b, s, w), np.float32)))  # sigmoid
    bb = rng.standard_normal((b, s, w), np.float32)
    h0 = rng.standard_normal((b, w), np.float32)
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0), chunk=chunk,
                          block_w=bw, interpret=True)
    oracle = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0))
    got = trg.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb), torch.from_numpy(h0))
    tor = tref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bb), torch.from_numpy(h0))
    for g, wv, t, o in zip(got, want, tor, oracle):
        _close(g, wv)
        _close(g, o)
        _close(t, o)


def test_scan_cuda_wrappers_check_before_launch():
    """The CUDA wrappers refuse what their kernels do not take before any
    build or launch (here on CPU tensors, which reach the checks only by a
    direct call); a tensor on another device type raises."""
    ins = [torch.from_numpy(x) for x in ssm_inputs(0, 1, 4, 8, 4)]
    with pytest.raises(ValueError, match="float32"):
        tss._ssm_scan_cuda(ins[0].double(), *ins[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tss._ssm_scan_cuda(ins[0], ins[1].transpose(1, 2).contiguous().transpose(1, 2),
                           *ins[2:])
    wide = [torch.from_numpy(x) for x in ssm_inputs(0, 1, 4, 8, 40)]
    with pytest.raises(ValueError, match="N=40"):
        tss._ssm_scan_cuda(*wide)
    a = torch.rand(2, 5, 7)
    with pytest.raises(ValueError, match="h0"):
        trg._rglru_scan_cuda(a, a, torch.zeros(2, 6))
    with pytest.raises(ValueError, match="cuda or cpu"):
        trg.rglru_scan(a.to("meta"), a.to("meta"), torch.zeros(2, 7, device="meta"))


@pytest.mark.parametrize("b,di", [(1, 100), (3, 96), (2, 8192), (8, 8192), (1, 8192), (5, 33)])
def test_scan_plan_covers_every_channel_once(b, di):
    """Block x of batch row r holds channels [x * cpb, min((x + 1) * cpb,
    di)), as the kernel's blockIdx and cols compute them: together they
    hold each (row, channel) exactly once, whatever B and di."""
    plan = tss.scan_plan(b, 16, di, 16)
    cpb, (nx, ny) = plan["channels"], plan["grid"]
    assert ny == b and plan["blocks"] == nx * ny and cpb in tss.CHANNEL_BLOCKS
    hits = np.zeros((b, di), np.int64)
    for r in range(ny):
        for x in range(nx):
            d0 = x * cpb
            assert d0 < di  # no block without a live channel
            hits[r, d0:min(d0 + cpb, di)] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("n,n_pad", [(1, 4), (4, 4), (5, 8), (12, 16), (16, 16), (17, 32),
                                     (32, 32)])
def test_scan_plan_pads_n_to_an_instance(n, n_pad):
    plan = tss.scan_plan(2, 64, 256, n)
    assert plan["n_pad"] == n_pad and plan["kernel"] == f"ssm_scan_kernel<{n_pad}>"
    assert plan["vec_n"] == (n % 4 == 0)


def test_scan_plan_refuses_before_any_launch():
    """What the kernel does not take raises ValueError in the plan, and in
    the CUDA wrapper before any build or launch (CPU tensors reach it only
    by a direct call)."""
    for n in (0, 33):
        with pytest.raises(ValueError, match=f"N={n}"):
            tss.scan_plan(2, 64, 256, n)
    for dt in (torch.float64, torch.bfloat16, torch.float16):
        with pytest.raises(ValueError, match="float32"):
            tss.scan_plan(2, 64, 256, 16, dt)
    with pytest.raises(ValueError, match="B=0"):
        tss.scan_plan(0, 64, 256, 16)
    reset_launch_counts()
    wide = [torch.from_numpy(x) for x in ssm_inputs(0, 1, 4, 8, 33)]
    with pytest.raises(ValueError, match="N=33"):
        tss._ssm_scan_cuda(*wide)
    ins = [torch.from_numpy(x) for x in ssm_inputs(0, 1, 4, 8, 4)]
    with pytest.raises(ValueError, match="float32"):
        tss._ssm_scan_cuda(*(t.bfloat16() for t in ins))
    assert launch_counts()["ssm_scan"] == 0


def test_scan_plan_mirrors_the_source_and_fits_shared_memory():
    """The plan's stage constants are the CUDA source's, its shared bytes
    are the source's ``smem_bytes`` (kStages stages of dt, x for the block's
    channels and B, C rows padded to NP) within the 48 KB the launch takes
    without opting in, and four blocks of up to 16 states fit on an SM with
    the 1 KB each block reserves, as the launch bounds ask."""
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "ssm_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kSteps") == tss.SCAN_STEPS and const("kStages") == tss.SCAN_STAGES
    assert const("kMaxChannels") == max(tss.CHANNEL_BLOCKS)
    for b, di, n in [(8, 8192, 16), (1, 8192, 16), (1, 96, 1), (64, 8192, 32)]:
        plan = tss.scan_plan(b, 256, di, n)
        want = 4 * plan["stages"] * 2 * plan["steps"] * (plan["channels"] + plan["n_pad"])
        assert plan["smem"] == want <= 48 * 1024
        if plan["n_pad"] <= 16:
            assert 4 * (plan["smem"] + 1024) <= 228 * 1024


def test_scan_plan_grid_at_the_main_paths_widths():
    """falcon-mamba-7b (di 8192): at B 8 the 128-channel blocks already
    give two blocks per SM of the H100's 132; at B 1 the plan takes the
    smallest block, 32 channels, for 256 blocks, the most that whole-warp
    blocks allow (8192 / 32 < 2 x 132)."""
    main = tss.scan_plan(8, 256, 8192, 16)
    assert main["channels"] == 128 and main["blocks"] == 512 >= 2 * tss.SM_COUNT
    one = tss.scan_plan(1, 2048, 8192, 16)
    assert one["channels"] == 32 and one["blocks"] == 8192 // 32
    assert tss.scan_plan(2, 300, 8192, 16)["blocks"] >= 2 * tss.SM_COUNT
    # another card's SM count moves the block size, never the instance
    other = tss.scan_plan(8, 256, 8192, 16, sms=512)
    assert other["channels"] == 64 and other["kernel"] == main["kernel"]


def test_scan_plan_arithmetic_does_not_depend_on_b():
    """A channel's arithmetic is fixed by the kernel instance (NP) and the
    stage shape alone; only the block size and the grid follow B, so a row
    computed alone gives the bits of its row in a batch."""
    fixed = {"kernel", "n_pad", "steps", "stages", "vec_d", "vec_n"}
    for n in (1, 12, 16, 32):
        plans = [tss.scan_plan(b, 256, 8192, n) for b in (1, 2, 3, 8, 64)]
        assert all({k: p[k] for k in fixed} == {k: plans[0][k] for k in fixed} for p in plans)
        assert len({p["channels"] for p in plans}) > 1  # B does move the block size


@pytest.fixture(scope="module")
def mamba_weights():
    jcfg = jconfigs.reduced(jconfigs.get_config("falcon-mamba-7b"))
    tcfg = tconfigs.reduced(tconfigs.get_config("falcon-mamba-7b"))
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1), jax.random.PRNGKey(0),
                             jnp.float32)
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("s", [256, 12])
@pytest.mark.parametrize("impls", IMPLS, ids=[i[0] for i in IMPLS])
def test_mamba_prefill_and_decode_logits_match(mamba_weights, impls, s):
    jcfg, jp, tcfg, tp = mamba_weights
    jcfg = dataclasses.replace(jcfg, kernel_impl=impls[1])
    tcfg = dataclasses.replace(tcfg, kernel_impl=impls[0])
    japi, tapi = _jitted(jax_get_model(jcfg)), get_model(tcfg)
    b = 3
    rng = np.random.default_rng(s)
    toks = rng.integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    jcache = jax_zeros_cache(jcfg, japi, b, s + 4)
    tcache = zeros_cache(tcfg, tapi, b, s + 4, device="cpu")
    assert tcache["ssm"].shape == jcache["ssm"].shape
    jl, jcache = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jcache)
    tl, tcache = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tcache)
    _close(tl, jl)
    _close(tcache["ssm"], jcache["ssm"])
    _close(tcache["conv"], jcache["conv"])

    tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.int32(s), jcfg, jcache)
    tl, tcache = tapi.decode(tp, torch.from_numpy(tok), s, tcfg, tcache)
    _close(tl, jl)

    # Vector positions: the ssm family ignores them, as the JAX package does.
    posv = np.asarray([5, s + 1, 3], np.int32)
    tok = rng.integers(0, tcfg.vocab, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.asarray(posv), jcfg, jcache)
    tl, tcache = tapi.decode(tp, torch.from_numpy(tok), torch.from_numpy(posv), tcfg, tcache)
    _close(tl, jl)
    _close(tcache["ssm"], jcache["ssm"])


@pytest.mark.parametrize("s", [2, 12, 256, 300])
def test_mamba_cuda_sends_every_prefill_to_the_kernel(mamba_weights, monkeypatch, s):
    """The CUDA kernel takes any S, so under "cuda" each layer's prefill
    calls the ``ssm_scan`` wrapper at the prompt's own length (the TPU
    kernel took only S % 256 == 0); "reference" never calls it.  The
    logits of the two agree at 1e-4."""
    _, _, tcfg, tp = mamba_weights
    real, calls = kops.ssm_scan, []

    def counted(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(kops, "ssm_scan", counted)
    toks = torch.from_numpy(np.random.default_rng(s).integers(0, tcfg.vocab, (2, s)))
    logits = {}
    for impl, want in (("reference", []), ("cuda", [s] * tcfg.n_layers)):
        cfg = dataclasses.replace(tcfg, kernel_impl=impl)
        api = get_model(cfg)
        logits[impl] = api.prefill(tp, {"tokens": toks}, cfg,
                                   zeros_cache(cfg, api, 2, s + 1, device="cpu"))[0]
        assert calls == want
    _close(logits["cuda"], logits["reference"])
