"""The port's two row-invariant kernels on the CPU: the GEMM (``linear``)
and ``rms_norm``, through their plain versions (CPU tensors), held to the
JAX package's products and norm, plus the layout the GEMM wrapper hands
the kernel, and the count of products and norms one forward of each
reduced family sends through them under ``kernel_impl="cuda"``.

Tolerance 1e-5 against JAX in float32 (the CPU backends order the
product's sums differently); the plain versions are held bitwise to the
plain torch expressions the models used before the kernels."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import layers as jlayers
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _build, gemm, ops
from repro_torch.kernels import rms_norm as rn
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.params import materialize
from repro_torch.serve import zeros_cache

TOL = 1e-5


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m,k,n,bias", [(1, 64, 96, False), (8, 64, 96, True),
                                        (37, 36, 100, True), (256, 128, 288, False)])
def test_linear_cpu_equals_matmul_plus_bias(m, k, n, bias):
    x, w, b = rnd(m, k), rnd(k, n, seed=1) / np.float32(np.sqrt(k)), rnd(n, seed=2)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = ops.linear(tx, tw, tb if bias else None)
    want = tx @ tw
    if bias:
        want = want + tb
    assert torch.equal(got, want)
    ref = np.asarray(jnp.asarray(x) @ jnp.asarray(w) + (jnp.asarray(b) if bias else 0.0))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_linear_cpu_bf16_and_tied_head():
    """bf16 products keep x's dtype, and a tied head's ``embed.T`` (the
    transposed layout) is the same product as a contiguous copy."""
    x = torch.from_numpy(rnd(3, 5, 64)).to(torch.bfloat16)
    embed = torch.from_numpy(rnd(200, 64, seed=3)).to(torch.bfloat16)
    got = ops.linear(x, embed.T)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 200)
    assert torch.equal(got, x @ embed.T)
    assert torch.equal(got, ops.linear(x, embed.T.contiguous()))


def test_linear_cpu_block_diagonal_equals_per_block_products():
    """A 3-D weight: one product per block, as the JAX package unrolls the
    recurrent gates (``xg[:, :, j] @ g[j]`` for each block j)."""
    b, s, nb, bw = 2, 7, 4, 16
    x, w, bias = rnd(b, s, nb, bw), rnd(nb, bw, bw, seed=1), rnd(nb, bw, seed=2)
    got = ops.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias))
    want = jnp.stack([jnp.asarray(x)[:, :, j] @ jnp.asarray(w)[j] for j in range(nb)],
                     axis=2) + jnp.asarray(bias)
    assert got.shape == (b, s, nb, bw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    plain = torch.einsum("bsnw,nwv->bsnv", torch.from_numpy(x),
                         torch.from_numpy(w)) + torch.from_numpy(bias)
    assert torch.equal(got, plain)


def test_operands_layouts():
    """What the wrapper passes the kernel: views where the layout allows,
    the row strides, the transposed flag and the block strides."""
    x = torch.zeros(2, 3, 64)
    w = torch.zeros(64, 40)
    o = gemm.operands(x, w)
    assert (o["m"], o["k"], o["n"], o["lda"], o["ldw"], o["ldy"], o["wt"]) == \
        (6, 64, 40, 64, 40, 40, 0)
    assert o["x2"].data_ptr() == x.data_ptr() and o["out_shape"] == (2, 3, 40)
    # dt_proj reads a split view of x_proj's output: rows 288 apart.
    xdb = torch.zeros(2, 5, 288)
    dt = torch.split(xdb, [256, 16, 16], dim=-1)[0]
    o = gemm.operands(dt, torch.zeros(256, 100))
    assert (o["m"], o["lda"]) == (10, 288) and o["x2"].data_ptr() == xdb.data_ptr()
    # The last position of a prefill: one row per batch element, S*d apart.
    h = torch.zeros(4, 9, 32)
    o = gemm.operands(h[:, -1:], torch.zeros(32, 8))
    assert (o["m"], o["lda"]) == (4, 9 * 32)
    # A tied head: embed.T is (K, N) stored as (N, K).
    embed = torch.zeros(500, 32)
    o = gemm.operands(torch.zeros(3, 32), embed.T)
    assert (o["wt"], o["ldw"], o["n"], o["k"]) == (1, 32, 500, 32)
    assert o["w2"].data_ptr() == embed.data_ptr()
    # Block-diagonal gates: one launch over nb blocks.
    o = gemm.operands(torch.zeros(2, 7, 10, 256), torch.zeros(10, 256, 256),
                      torch.zeros(10, 256))
    assert (o["batch"], o["m"], o["lda"], o["sx"], o["sw"], o["ldy"], o["sy"], o["sb"]) == \
        (10, 14, 2560, 256, 65536, 2560, 256, 256)
    with pytest.raises(ValueError):
        gemm.operands(torch.zeros(3, 33), torch.zeros(32, 8))
    with pytest.raises(ValueError):
        gemm.operands(torch.zeros(3, 32), torch.zeros(32, 8), torch.zeros(9))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_rows_bitwise_equal_at_batch_1_and_8(dtype):
    x = torch.from_numpy(rnd(8, 5, 256)).to(dtype)
    w = torch.from_numpy(1 + 0.1 * rnd(256, seed=1)).to(dtype)
    batch = ops.rms_norm(x, w, 1e-6)
    for i in range(8):
        assert torch.equal(ops.rms_norm(x[i:i + 1], w, 1e-6)[0], batch[i])
    assert torch.equal(batch, L.rms_norm(x, w, 1e-6))  # the reference path


def test_rms_norm_cpu_matches_jax():
    x, w = rnd(4, 6, 64), 1 + 0.1 * rnd(64, seed=1)
    got = ops.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert rn.rms_norm_plain is L.rms_norm_plain


def test_wrappers_refuse_other_devices():
    """No silent fallback: only CPU tensors take the plain versions."""
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.linear(x, torch.empty((8, 4), device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.rms_norm(x, torch.empty((8,), device="meta"), 1e-6)


def test_launch_count_is_exact_across_threads():
    """Co-executing groups launch from their own worker threads: counts
    taken under the lock lose no launch."""
    ops.reset_launch_counts()

    def bump():
        for _ in range(2000):
            _build.count("gemm_rowinv")

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ops.launch_counts()["gemm_rowinv"] == 8000
    ops.reset_launch_counts()
    assert set(_build.KERNELS) >= {"gemm_rowinv", "rms_norm"}


def expected_calls(cfg):
    """(products, norms) of one forward: dense layer q, k, v, o + three MLP
    products; Mamba layer in_proj, x_proj, dt_proj, out_proj; recurrent
    layer in_y, in_x, two gates, out + three MLP products; local attention
    layer four + three; the head; one norm per sublayer and the final
    norm."""
    n = cfg.n_layers
    if cfg.family == "dense":
        return 7 * n + 1, 2 * n + 1
    if cfg.family == "ssm":
        return 4 * n + 1, n + 1
    pat = cfg.block_pattern
    kinds = list(pat) * (n // len(pat)) + list(pat[: n % len(pat)])
    rec = kinds.count("rec")
    return 8 * rec + 7 * (n - rec) + 1, 2 * n + 1


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "internlm2-20b", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
@pytest.mark.parametrize("impl", ["cuda", "reference"])
def test_every_product_goes_through_linear(arch, impl, monkeypatch):
    """One prefill and one decode step of the reduced family: under
    "cuda" every product goes through ``kernels.gemm.linear`` and every
    norm through ``kernels.rms_norm.rms_norm`` (the expected counts);
    under "reference" neither is called."""
    calls = {"linear": 0, "rms_norm": 0}
    real_linear, real_norm = ops.linear, ops.rms_norm

    def linear(*a, **kw):
        calls["linear"] += 1
        return real_linear(*a, **kw)

    def norm(*a, **kw):
        calls["rms_norm"] += 1
        return real_norm(*a, **kw)

    monkeypatch.setattr(ops, "linear", linear)
    monkeypatch.setattr(ops, "rms_norm", norm)
    cfg = dataclasses.replace(reduced(get_config(arch)), kernel_impl=impl)
    api = get_model(cfg)
    cpu = torch.device("cpu")
    params = materialize(api.param_spec(cfg), torch.Generator().manual_seed(0),
                         torch.float32, cpu)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
                              .astype(np.int32))
    cache = zeros_cache(cfg, api, 2, 10, device=cpu)
    logits, cache = api.prefill(params, {"tokens": tokens}, cfg, cache)
    products, norms = expected_calls(cfg) if impl == "cuda" else (0, 0)
    assert calls == {"linear": products, "rms_norm": norms}
    api.decode(params, logits.argmax(-1).int(), 8, cfg, cache)
    assert calls == {"linear": 2 * products, "rms_norm": 2 * norms}
