"""The port's vlm family (paligemma-3b) vs the JAX package.

Reduced paligemma-3b (d 64, 4 heads over 1 kv head of 16, 2 layers, a tied
head, 4 image-patch embeddings as a prefix) with JAX parameters loaded by
``load_jax_params``; numpy-seeded patches and tokens.  The port is held to
the JAX package's model functions: ``api.prefill`` over the patches and the
prompt, and ``api.decode`` at ``n_patches + s + i``.  Its ``make_generate``
is held to greedy generation by re-prefilling through the JAX package's
``api.prefill``, not to the JAX ``make_generate``, which sizes the cache
without the prefix and starts decoding at ``s`` (ROADMAP.md C9).  The
port's "reference" is held against the JAX "reference", the port's "cuda"
(CPU tensors: the kernels' plain versions, ``flash_attention``'s prefix-LM
mode among them) against the JAX "pallas_interpret", at 1e-4 in float32.
"""
import dataclasses

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
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as A
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import make_generate, zeros_cache
from repro_torch.serve.step import prefix_len

TOL = 1e-4
BF16_REL = 2e-2
IMPLS = [("reference", "reference"), ("cuda", "pallas_interpret")]


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t, np.float32), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.reduced(jconfigs.get_config("paligemma-3b"))
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1), jax.random.PRNGKey(0),
                             jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get_config("paligemma-3b"))
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _cfgs(weights, timpl, jimpl):
    jcfg, jp, tcfg, tp = weights
    return (dataclasses.replace(jcfg, kernel_impl=jimpl), jp,
            dataclasses.replace(tcfg, kernel_impl=timpl), tp)


def _batch(cfg, b=2, s=6, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "patches": rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# b, s, H, KV, hd, prefix, window, block_q, block_k
PREFIX_CASES = [
    (2, 20, 4, 1, 16, 8, 0, 64, 64),     # MQA, one tile
    (2, 40, 6, 2, 16, 13, 0, 8, 8),      # GQA, the prefix ends inside a tile
    (1, 33, 4, 4, 8, 32, 0, 16, 16),     # every row but the last in the prefix
    (2, 24, 4, 1, 16, 1, 0, 8, 8),       # a prefix of one: plain causal
    (2, 36, 4, 2, 16, 12, 5, 8, 8),      # a window that the prefix rows ignore
    (1, 16, 2, 1, 16, 16, 0, 8, 8),      # all rows in the prefix: bidirectional
]


@pytest.mark.parametrize("case", PREFIX_CASES, ids=[f"case{i}" for i in range(len(PREFIX_CASES))])
def test_flash_attention_prefix_mode_matches_jax(case):
    """``flash_attention_plain``'s prefix-LM mode (the kernel's tile walk,
    several tiles of q and k) against the JAX package's
    ``_prefix_lm_attention``, in float32 and bfloat16; the wrapper on CPU
    tensors is the plain version."""
    b, s, h, kv, hd, p, window, bq, bk = case
    rng = np.random.default_rng(s * 7 + p)
    q, k, v = (rng.normal(size=(b, s, n, hd)).astype(np.float32) for n in (h, kv, kv))
    cfg = jconfigs.reduced(jconfigs.get_config("paligemma-3b"))
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
        want = jattn._prefix_lm_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), cfg, p,
                                          window)
        tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
        got = fa.flash_attention_plain(tq, tk, tv, causal=True, window=window, prefix_len=p,
                                       block_q=bq, block_k=bk)
        assert torch.equal(fa.flash_attention(tq, tk, tv, causal=True, window=window,
                                              prefix_len=p, block_q=bq, block_k=bk), got)
        ref = A._prefix_lm_attention(tq, tk, tv, p, window)
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            _close(got, want)
            _close(ref, want)
        else:
            for t in (got, ref):
                t = t.float().numpy()
                assert np.linalg.norm(t - want) / np.linalg.norm(want) < BF16_REL


def test_prefix_tile_range():
    """Rows inside the prefix reach its last tile; rows past it keep the
    causal range; a window does not cut a range whose rows start in the
    prefix."""
    tr = fa._tile_range
    assert tr(0, 7, 64, 8, True, 0, 20) == (0, 3)
    assert tr(24, 31, 64, 8, True, 0, 20) == (0, 4)
    assert tr(16, 23, 64, 8, True, 0, 20) == (0, 3)
    assert tr(40, 47, 64, 8, True, 16, 20) == (3, 6)
    assert tr(16, 23, 64, 8, True, 4, 20) == (0, 3)
    assert tr(0, 7, 64, 8, True, 0, 0) == (0, 1)
    with pytest.raises(ValueError, match="prefix_len"):
        fa.launch_plan(1, 8, 8, 2, 1, 16, torch.float32, prefix_len=-1)


def test_load_jax_params_keeps_the_tree(weights):
    jcfg, jp, tcfg, tp = weights
    assert sorted(tp) == sorted(jp) == ["embed", "final_norm", "layers"]
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    np_tree["embed"] = np_tree["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        tparams.load_jax_params(np_tree, tcfg, "cpu")


@pytest.mark.parametrize("timpl,jimpl", IMPLS)
def test_prefill_and_decode_match_jax(weights, timpl, jimpl):
    """Prefill logits and every cache leaf, then three decode steps at
    ``n_patches + s + i``, scalar and per-slot positions."""
    jcfg, jp, tcfg, tp = _cfgs(weights, timpl, jimpl)
    japi, tapi = jax_get_model(jcfg), get_model(tcfg)
    b, s, gen = 2, 6, 4
    n = prefix_len(tcfg)
    assert n == tcfg.n_patches == 4
    batch = _batch(tcfg, b, s)
    jl, jc = japi.prefill(jp, _jax_batch(batch), jcfg,
                          jserve.zeros_cache(jcfg, japi, b, n + s + gen))
    tc = zeros_cache(tcfg, tapi, b, n + s + gen, device="cpu")
    tl, _ = tapi.prefill(tp, _torch_batch(batch), tcfg, tc)
    _close(tl, jl)
    assert int(tc["pos"][0, 0].max()) == n + s - 1
    for t, j in zip(tparams.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        _close(t, j)
    rng = np.random.default_rng(5)
    for i in range(3):
        tok = rng.integers(0, tcfg.vocab, (b, 1)).astype(np.int32)
        jpos = jnp.int32(n + s + i) if i != 1 else jnp.full((b,), n + s + i, jnp.int32)
        tpos = n + s + i if i != 1 else torch.full((b,), n + s + i, dtype=torch.int32)
        jl, jc = japi.decode(jp, jnp.asarray(tok), jpos, jcfg, jc)
        tl, tc = tapi.decode(tp, torch.from_numpy(tok), tpos, tcfg, tc)
        _close(tl, jl)
        for t, j in zip(tparams.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
            _close(t, j)


@pytest.mark.parametrize("timpl,jimpl", IMPLS)
def test_make_generate_equals_greedy_reprefill(weights, timpl, jimpl):
    """Generate's tokens are greedy decoding of the JAX model functions:
    each next token the argmax of ``api.prefill`` over the patches, the
    prompt and the tokens so far."""
    jcfg, jp, tcfg, tp = _cfgs(weights, timpl, jimpl)
    japi, tapi = jax_get_model(jcfg), get_model(tcfg)
    b, s, gen = 2, 6, 5
    batch = _batch(tcfg, b, s, seed=0)
    got = make_generate(tcfg, tapi)(tp, _torch_batch(batch), gen).numpy()
    toks = batch["tokens"]
    want = []
    for _ in range(gen):
        jb = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(batch["patches"])}
        cache = jserve.zeros_cache(jcfg, japi, b, tcfg.n_patches + toks.shape[1])
        logits, _ = japi.prefill(jp, jb, jcfg, cache)
        nxt = np.asarray(logits[:, -1].argmax(-1), np.int32)[:, None]
        want.append(nxt)
        toks = np.concatenate([toks, nxt], axis=1)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))
