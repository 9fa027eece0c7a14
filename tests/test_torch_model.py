"""The port's dense model vs the JAX package on the same weights.

JAX parameters from ``materialize(..., PRNGKey(0), float32)`` cross as
numpy through ``load_jax_params``; both sides then run prefill, scalar- and
vector-position decode and multi-row decode on reduced qwen1.5-4b (QKV
bias, no GQA) and reduced internlm2-20b (GQA), in float32.  The port's
"reference" path is held against the JAX "reference" path, and the port's
"cuda" path (CPU tensors, so the kernels' plain versions) against the JAX
"pallas_interpret" path.

Tolerance 1e-4 on logits: XLA and torch order float32 matrix-product sums
differently on the CPU."""
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
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import zeros_cache

TOL = 1e-4
ARCHS = ["qwen1.5-4b", "internlm2-20b"]
IMPLS = [("reference", "reference"), ("cuda", "pallas_interpret")]


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    jcfg = jconfigs.reduced(jconfigs.get_config(request.param))
    jparams_ = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1),
                                   jax.random.PRNGKey(0), jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get_config(request.param))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams_)
    return jcfg, jparams_, tcfg, tparams.load_jax_params(np_tree, tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS + ["falcon-mamba-7b", "recurrentgemma-2b", "arctic-480b",
                                  "kimi-k2-1t-a32b", "codeqwen1.5-7b", "granite-34b",
                                  "whisper-tiny", "paligemma-3b"])
def test_configs_are_copies(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(jconfigs.reduced(j)) == dataclasses.asdict(tconfigs.reduced(t))


def test_shape_cells_are_copies():
    """The dry-run's cells and their applicability: ``ShapeCell``,
    ``SHAPES``, ``cell_applicable`` and ``all_archs`` equal the JAX
    package's."""
    assert [f.name for f in dataclasses.fields(tconfigs.ShapeCell)] == \
        [f.name for f in dataclasses.fields(jconfigs.base.ShapeCell)]
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.all_archs() == jconfigs.all_archs()
    for arch in tconfigs.all_archs():
        for name in tconfigs.SHAPES:
            assert tconfigs.cell_applicable(tconfigs.get_config(arch), tconfigs.SHAPES[name]) == \
                jconfigs.cell_applicable(jconfigs.get_config(arch), jconfigs.SHAPES[name])


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


def test_every_jax_arch_is_ported():
    """The port registers every arch of the JAX package, and its registry
    gives each a model."""
    assert sorted(jconfigs.base._REGISTRY) == sorted(tconfigs.base._REGISTRY)
    for name in tconfigs.base._REGISTRY:
        get_model(tconfigs.get_config(name))


def test_load_jax_params_checks_shapes(weights):
    jcfg, jp, tcfg, tp = weights
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    np_tree["final_norm"] = np_tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        tparams.load_jax_params(np_tree, tcfg, "cpu")


def test_materialize_honours_inits(weights):
    _, _, tcfg, _ = weights
    spec = get_model(tcfg).param_spec(tcfg)
    p = tparams.materialize(spec, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert torch.equal(p["final_norm"], torch.ones(tcfg.d_model))
    assert abs(float(p["embed"].std()) - 0.02) < 0.002  # small_normal at 0.02
    d = tcfg.d_model
    assert abs(float(p["layers"]["mlp"]["w_gate"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    if tcfg.qkv_bias:
        assert not torch.any(p["layers"]["attn"]["bq"])
    cache = zeros_cache(tcfg, get_model(tcfg), 2, 8, device="cpu")
    assert torch.all(cache["pos"] == -1) and cache["pos"].dtype == torch.int32


def _both(weights, impls):
    jcfg, jp, tcfg, tp = weights
    jcfg = dataclasses.replace(jcfg, kernel_impl=impls[1])
    tcfg = dataclasses.replace(tcfg, kernel_impl=impls[0])
    return jcfg, jax_get_model(jcfg), jp, tcfg, get_model(tcfg), tp


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("impls", IMPLS, ids=[i[0] for i in IMPLS])
def test_prefill_and_decode_logits_match(weights, impls):
    jcfg, japi, jp, tcfg, tapi, tp = _both(weights, impls)
    b, s, max_seq = 3, 8, 16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    jcache = jax_zeros_cache(jcfg, japi, b, max_seq)
    tcache = zeros_cache(tcfg, tapi, b, max_seq, device="cpu")

    jl, jcache = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jcache)
    tl, tcache = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tcache)
    _close(tl, jl)
    _close(tcache["k"], jcache["k"])
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))

    # Scalar-position decode of the greedy token.
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.int32(s), jcfg, jcache)
    tl, tcache = tapi.decode(tp, torch.from_numpy(tok), s, tcfg, tcache)
    _close(tl, jl)

    # Vector positions: slots at different depths of their own timeline.
    posv = np.asarray([5, s + 1, 3], np.int32)
    tok = rng.integers(0, tcfg.vocab, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.asarray(posv), jcfg, jcache)
    tl, tcache = tapi.decode(tp, torch.from_numpy(tok), torch.from_numpy(posv), tcfg, tcache)
    _close(tl, jl)

    # Multi-row decode: 3 rows per slot at pos .. pos+2.
    posv = np.asarray([6, s + 2, 4], np.int32)
    tok = rng.integers(0, tcfg.vocab, (b, 3)).astype(np.int32)
    jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.asarray(posv), jcfg, jcache)
    tl, tcache = tapi.decode(tp, torch.from_numpy(tok), torch.from_numpy(posv), tcfg, tcache)
    _close(tl, jl)
    _close(tcache["v"], jcache["v"])
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_rolling_window_cache_matches():
    """A windowed config (ring cache, window-masked attention) through both
    packages' reference paths."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config("internlm2-20b")),
                               window=6)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("internlm2-20b")),
                               window=6)
    japi, tapi = jax_get_model(jcfg), get_model(tcfg)
    jp = jparams.materialize(japi.param_spec(jcfg, 1), jax.random.PRNGKey(2), jnp.float32)
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 9)).astype(np.int32)
    jcache = jax_zeros_cache(jcfg, japi, 2, 16)
    tcache = zeros_cache(tcfg, tapi, 2, 16, device="cpu")
    assert tcache["k"].shape == jcache["k"].shape  # ring of `window` slots
    jl, jcache = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jcache)
    tl, tcache = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tcache)
    _close(tl, jl)
    for step in range(3):
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jcache = japi.decode(jp, jnp.asarray(tok), jnp.int32(9 + step), jcfg, jcache)
        tl, tcache = tapi.decode(tp, torch.from_numpy(tok), 9 + step, tcfg, tcache)
        _close(tl, jl)
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
