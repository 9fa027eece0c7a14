"""The port's hybrid family (recurrentgemma-2b) vs the JAX package.

Reduced recurrentgemma-2b with JAX parameters loaded by
``load_jax_params`` (the ``units``/``tail`` tree): 3 layers (one
(rec, rec, attn) unit, no tail, as ``reduced()`` gives) and 5 layers (one
unit and a (rec, rec) tail, the full config's layout).  A 12-token prompt
into a window of 8, then decode steps, so the attention ring wraps; the
rec layers reach the RG-LRU scan kernel (its plain version on the CPU) in
both packages.  Prefill and decode logits, scalar and vector positions, and
the caches in float32 at 1e-4 (XLA and torch order float32 sums
differently); vector-position rows by tolerance, never bitwise (ROADMAP.md
C2).  The port's "reference" is held against the JAX "reference", the
port's "cuda" against the JAX "pallas_interpret".  The port's "cuda" sends
every rec layer's prefill of S > 1 to the ``rglru_scan`` wrapper, 300
tokens included (the TPU kernel took S <= 256 or S % 256 == 0), and agrees
with its "reference" at 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro.serve import zeros_cache as jax_zeros_cache
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as kops
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.models import rglru
from repro_torch.serve import zeros_cache

TOL = 1e-4
IMPLS = [("reference", "reference"), ("cuda", "pallas_interpret")]


def _jitted(api):
    """The JAX model's prefill and decode under ``jax.jit`` (config
    static): op-by-op dispatch of the recurrent stacks costs many seconds a
    call on the CPU."""
    return api._replace(prefill=jax.jit(api.prefill, static_argnums=2),
                        decode=jax.jit(api.decode, static_argnums=3))


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=TOL, rtol=TOL)


def _cfgs(n_layers):
    jcfg = jconfigs.reduced(jconfigs.get_config("recurrentgemma-2b"))
    tcfg = tconfigs.reduced(tconfigs.get_config("recurrentgemma-2b"))
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=[None, 5], ids=["reduced", "5-layers"])
def weights(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1), jax.random.PRNGKey(0),
                             jnp.float32)
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def test_layouts_match_jax(weights):
    jcfg, jp, tcfg, tp = weights
    n_units, tail = rglru._pattern_layout(tcfg)
    assert (n_units, tail) == ((1, ()) if tcfg.n_layers == 3 else (1, ("rec", "rec")))
    assert sorted(tp["tail"]) == sorted(jp["tail"])
    gate = tp["units"]["l0_rec"]["mix"]["gate_a"]
    assert gate.shape == jp["units"]["l0_rec"]["mix"]["gate_a"].shape
    cache = zeros_cache(tcfg, get_model(tcfg), 1, 4, device="cpu")
    kinds = [f.keywords["kind"] for f, _, _ in rglru.stack_order(tp, cache, tcfg)]
    assert kinds == ["rec", "rec", "attn", "rec", "rec"][: tcfg.n_layers]


@pytest.mark.parametrize("impls", IMPLS, ids=[i[0] for i in IMPLS])
def test_prefill_and_decode_logits_match(weights, impls):
    jcfg, jp, tcfg, tp = weights
    jcfg = dataclasses.replace(jcfg, kernel_impl=impls[1])
    tcfg = dataclasses.replace(tcfg, kernel_impl=impls[0])
    japi, tapi = _jitted(jax_get_model(jcfg)), get_model(tcfg)
    b, s, max_seq = 3, 12, 24
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    jcache = jax_zeros_cache(jcfg, japi, b, max_seq)
    tcache = zeros_cache(tcfg, tapi, b, max_seq, device="cpu")
    assert tcache["units"]["l2_attn"]["k"].shape[2] == tcfg.window  # ring of 8 slots
    jl, jcache = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jcache)
    tl, tcache = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tcache)
    _close(tl, jl)
    _close(tcache["units"]["l0_rec"]["h"], jcache["units"]["l0_rec"]["h"])

    for step in range(3):  # scalar positions, past the window
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.int32(s + step), jcfg, jcache)
        tl, tcache = tapi.decode(tp, torch.from_numpy(tok), s + step, tcfg, tcache)
        _close(tl, jl)

    posv = np.asarray([s + 3, s + 5, s + 4], np.int32)  # vector positions
    tok = rng.integers(0, tcfg.vocab, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.asarray(posv), jcfg, jcache)
    tl, tcache = tapi.decode(tp, torch.from_numpy(tok), torch.from_numpy(posv), tcfg, tcache)
    _close(tl, jl)
    jattn, tattn = jcache["units"]["l2_attn"], tcache["units"]["l2_attn"]
    assert np.array_equal(tattn["pos"].numpy(), np.asarray(jattn["pos"]))
    _close(tattn["k"], jattn["k"])
    for key in tcache["tail"]:
        _close(tcache["tail"][key]["h"], jcache["tail"][key]["h"])
        _close(tcache["tail"][key]["conv"], jcache["tail"][key]["conv"])


def test_materialize_honours_lambda_init():
    """``lambda_init`` leaves are lam = -log(expm1(-log u)) of u drawn
    uniform in (0.9, 0.999), so 1 - exp(-softplus(lam)) gives u back."""
    _, tcfg = _cfgs(None)
    spec = get_model(tcfg).param_spec(tcfg)
    p = tparams.materialize(spec, torch.Generator().manual_seed(0), torch.float32, "cpu")
    lam = p["units"]["l0_rec"]["mix"]["lam"]
    assert lam.shape == (1, tcfg.lru_width) and torch.isfinite(lam).all()
    u = 1 - torch.exp(-torch.nn.functional.softplus(lam.double()))
    assert u.min() >= 0.9 - 1e-6 and u.max() <= 0.999 + 1e-6
    assert u.max() - u.min() > 0.05  # spread over the range, not a constant


@pytest.mark.parametrize("s", [2, 12, 300])
def test_cuda_sends_every_rec_prefill_to_the_kernel(weights, monkeypatch, s):
    """Under "cuda" each rec layer's prefill calls the ``rglru_scan``
    wrapper at the prompt's own length; "reference" never calls it.  The
    logits of the two agree at 1e-4."""
    _, _, tcfg, tp = weights
    real, calls = kops.rglru_scan, []

    def counted(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(kops, "rglru_scan", counted)
    n_rec = sum(k == "rec" for k in (tcfg.block_pattern * tcfg.n_layers)[: tcfg.n_layers])
    toks = torch.from_numpy(np.random.default_rng(s).integers(0, tcfg.vocab, (2, s)))
    logits = {}
    for impl, want in (("reference", []), ("cuda", [s] * n_rec)):
        cfg = dataclasses.replace(tcfg, kernel_impl=impl)
        api = get_model(cfg)
        logits[impl] = api.prefill(tp, {"tokens": toks}, cfg,
                                   zeros_cache(cfg, api, 2, s + 1, device="cpu"))[0]
        assert calls == want
    _close(logits["cuda"], logits["reference"])
