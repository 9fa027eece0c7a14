"""Port's flash_attention (its plain version, on CPU tensors) vs the JAX
package's Pallas kernel in interpret mode and its dense oracle, on the
cases of tests/test_kernels.py.

Tolerances are the reference suite's own: 2e-5 for float32 and 2e-2 for
bfloat16 (both frameworks round bf16 at the same points; only the order of
the float32 sums differs)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.ops import flash_attention as jax_flash_attention
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import flash_attention, launch_counts, reset_launch_counts

CASES = [  # b, sq, sk, h, kv, hd, causal, window, q_offset
    (1, 128, 128, 2, 2, 64, True, 0, 0),
    (2, 128, 128, 4, 1, 32, True, 0, 0),  # MQA
    (1, 192, 192, 2, 2, 64, True, 0, 0),  # unaligned
    (1, 64, 320, 2, 1, 64, True, 0, 256),  # q_offset 256
    (1, 128, 128, 4, 2, 64, True, 64, 0),  # sliding window 64
    (1, 128, 128, 2, 2, 64, False, 0, 0),  # bidirectional
    (1, 128, 128, 2, 2, 128, True, 0, 0),  # hd 128
]
IDS = ["basic", "mqa", "unaligned192", "qoffset256", "window64", "bidirectional", "hd128"]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(case, seed=7):
    b, sq, sk, h, kv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd), np.float32),
            rng.standard_normal((b, sk, kv, hd), np.float32),
            rng.standard_normal((b, sk, kv, hd), np.float32))


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_jax_oracle(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    causal, window, qoff = case[6:]
    q, k, v = inputs(case)
    want = jref.flash_attention_ref(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                    causal=causal, window=window, q_offset=qoff)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, window=window, q_offset=qoff)
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
    # The port's own oracle is the JAX oracle.
    oracle = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                      q_offset=qoff)
    np.testing.assert_allclose(f32(oracle), f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,case", [("float32", c) for c in CASES]
                         + [("bfloat16", CASES[1]), ("bfloat16", CASES[4])],
                         ids=[f"float32-{i}" for i in IDS] + ["bfloat16-mqa",
                                                             "bfloat16-window64"])
def test_plain_matches_jax_pallas_interpret(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    causal, window, qoff = case[6:]
    q, k, v = inputs(case)
    want = jax_flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal,
                               window=window, q_offset=qoff, block_q=64, block_k=64,
                               interpret=True)
    reset_launch_counts()
    got = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                          causal=causal, window=window, q_offset=qoff)
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("block_q,block_k", [(32, 64), (64, 32), (128, 128)])
def test_plain_tiling_does_not_change_the_function(block_q, block_k):
    """Tile sizes change only the order of the float32 sums."""
    case = CASES[4]
    q, k, v = (torch.from_numpy(x) for x in inputs(case, seed=3))
    base = flash_attention(q, k, v, window=64)
    got = flash_attention(q, k, v, window=64, block_q=block_q, block_k=block_k)
    np.testing.assert_allclose(f32(got), f32(base), atol=2e-5, rtol=2e-5)


def test_non_cpu_non_cuda_tensor_raises():
    """No silent fallback: only CPU tensors take the plain version."""
    q = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)


# Shapes the card launches (chip_smoke.py's kernel cases and its main
# paths' prefills): b, sq, sk, h, kv, hd, dtype, the body they must take.
CHIP_SHAPES = {
    "qwen1.5-4b prefill (main path, served)": (8, 256, 256, 20, 20, 128, "bfloat16", "mma"),
    "qwen1.5-4b f32": (8, 256, 256, 20, 20, 128, "float32", "fma"),
    "internlm2-20b widths": (2, 256, 256, 48, 8, 128, "bfloat16", "mma"),
    "unaligned 300": (2, 300, 300, 20, 20, 128, "bfloat16", "mma"),
    "q_offset 256": (2, 64, 320, 48, 8, 128, "bfloat16", "mma"),
    "bidirectional 192": (2, 192, 192, 20, 20, 128, "bfloat16", "mma"),
    "recurrentgemma-2b 8 x 256": (8, 256, 256, 10, 1, 256, "bfloat16", "mma"),
    "recurrentgemma-2b 2 x 2048": (2, 2048, 2048, 10, 1, 256, "bfloat16", "mma"),
    "recurrentgemma-2b 2 x 300": (2, 300, 300, 10, 1, 256, "bfloat16", "mma"),
    "hd 256 f32": (2, 256, 256, 10, 1, 256, "float32", "fma"),
}


@pytest.mark.parametrize("name", list(CHIP_SHAPES))
def test_launch_plan_admits_chip_shapes(name):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import heads_per_block, launch_plan

    b, sq, sk, h, kv, hd, dtype, route = CHIP_SHAPES[name]
    plan = launch_plan(b, sq, sk, h, kv, hd, getattr(torch, dtype))
    assert plan["route"] == route
    assert plan["smem"] <= _build.MAX_SMEM and plan["grid"][1] <= 65535
    if route == "mma":
        g = heads_per_block(h // kv)
        assert plan["rows"] == _build.MMA_ROWS and (h // kv) % g == 0
        # Every (position, head) row of the batch has one block.
        assert plan["grid"] == (b * h // g, -(-sq * g // 64))


@pytest.mark.parametrize("args,match", [
    ((1, 64, 64, 4, 3, 128, torch.bfloat16), "multiple of KV"),
    ((1, 64, 64, 4, 4, 1024, torch.float32), "too wide"),
    ((1, 64, 64, 4, 4, 6, torch.float32), "16-byte"),
    ((1, 64, 64, 4, 4, 128, torch.float16), "float32 or bfloat16"),
    ((70000, 64, 64, 1, 1, 128, torch.float32), "65535"),
], ids=["gqa-ratio", "f32-too-wide", "unaligned-rows", "fp16", "grid"])
def test_launch_plan_rejects(args, match):
    from repro_torch.kernels.flash_attention import launch_plan

    with pytest.raises(ValueError, match=match):
        launch_plan(*args)


@pytest.mark.parametrize("hd,block_k,route", [(128, 64, "mma"), (256, 64, "mma"),
                                              (64, 32, "mma"), (96, 64, "fma"),
                                              (128, 40, "fma")])
def test_launch_plan_route_and_stages(hd, block_k, route):
    """bf16 takes the tensor-core body at hd 64/128/256 and tiles of a
    multiple of 16 keys; stages stay within the registers' reach (at most
    32 keys a warp at hd 256)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import launch_plan

    plan = launch_plan(2, 128, 128, 4, 4, hd, torch.bfloat16, block_k=block_k)
    assert plan["route"] == route
    if route == "mma":
        ks, sb, kw = _build.mma_plan(64, block_k, hd)
        assert (ks, plan["stage_keys"]) == (1, sb) and block_k % sb == 0
        assert kw <= (32 if hd > 128 else 64)


# --------------------------------------------- the backward (autograd Function)
# The port's dq, dk, dv through ``flash_attention``'s Function (CPU tensors:
# its forward is the plain version, its backward the reference's recompute)
# against ``jax.grad`` through the JAX kernel in interpret mode, whose
# custom VJP recomputes the same way (the counterpart of
# tests/test_kernels.py::test_flash_attention_grad_path).  float32 at 2e-5,
# the reference suite's float32 tolerance (measured up to 9.3e-7 against
# 1 + |grad|).
GRAD_CASES = {"causal": CASES[0], "mqa": CASES[1], "qoffset256": CASES[3],
              "window64": CASES[4], "bidirectional": CASES[5]}
GRAD_TOL = 2e-5


def _port_grads(q, k, v, dout, **kw):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    return out, torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_function_grads_match_jax_interpret(name):
    import jax

    case = GRAD_CASES[name]
    causal, window, qoff = case[6:]
    q, k, v = inputs(case, seed=11)
    dout = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    _, got = _port_grads(q, k, v, dout, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, block_q=64, block_k=64,
                                                         interpret=True, **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(f32(g), f32(w), atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("prefix,window,kv", [(48, 0, 1), (96, 0, 2), (40, 32, 2)],
                         ids=["mqa-p48", "gqa-p96", "window32-p40"])
def test_function_prefix_grads_match_jax(prefix, window, kv):
    """The prefix-LM mode's gradients against ``jax.grad`` of the JAX
    package's ``_prefix_lm_attention``, which its backward recomputes."""
    import jax

    from repro.models.attention import _prefix_lm_attention

    q, k, v = inputs((2, 128, 128, 4, kv, 32), seed=13)
    dout = np.random.default_rng(14).standard_normal(q.shape).astype(np.float32)
    out, got = _port_grads(q, k, v, dout, causal=True, window=window, prefix_len=prefix)
    want, vjp = jax.vjp(lambda a, b, c: _prefix_lm_attention(a, b, c, None, prefix, window),
                        *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(f32(out.detach()), f32(want), atol=GRAD_TOL, rtol=GRAD_TOL)
    for g, w in zip(got, vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(f32(g), f32(w), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_function_chunked_recompute_branch(monkeypatch):
    """Above 2^20 (query, key) pairs :func:`recompute` (the parent design's
    backward, the card's yardstick) goes through ``chunked_attention`` in
    chunks of 1024, as ``_flash_vjp_bwd`` does, and its gradient matches
    jax.grad through the JAX kernel (whose VJP chunks too)."""
    import jax

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L

    chunked = []
    real = L.chunked_attention
    monkeypatch.setattr(L, "chunked_attention",
                        lambda *a, **kw: chunked.append(kw) or real(*a, **kw))
    case = (1, 1040, 1040, 2, 1, 16, True, 0, 0)
    q, k, v = inputs(case, seed=15)
    dout = np.random.default_rng(16).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.recompute(tq, tk, tv, causal=True, window=0, q_offset=0, prefix_len=0)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    assert [(c["q_chunk"], c["kv_chunk"]) for c in chunked] == [(1024, 1024)]
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, block_q=128, block_k=128,
                                                         interpret=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(f32(g), f32(w), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_function_forward_is_the_plain_call_bitwise():
    """The Function's forward output is the dispatch's own, bit for bit,
    and without autograd the call does not go through the Function."""
    q, k, v = (torch.from_numpy(x) for x in inputs(CASES[1], seed=17))
    plain = flash_attention(q, k, v)
    assert plain.grad_fn is None
    out = flash_attention(q.clone().requires_grad_(), k, v)
    assert torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert flash_attention(q.clone().requires_grad_(), k, v).grad_fn is None


# ------------------------------------ C10: no CUDA wrapper passes autograd by
# Each public wrapper of kernels/ops.py refuses (RuntimeError) when grad mode
# is on and an input off the CPU requires grad -- its kernel writes a fresh
# tensor that carries no grad_fn -- before its device dispatch, so `meta`
# tensors reach the refusal here; under torch.no_grad() they pass it and the
# dispatch refuses the device instead.  flash_attention goes through its
# autograd Function, whose raw launch refuses in turn.  CPU tensors take the
# plain versions, which differentiate.
NOT_WRAPPERS = {"launch_counts", "multi_row_counts", "reset_launch_counts", "needed_tiles"}


def _t(device, shape, dtype=torch.float32):
    t = torch.zeros(shape, dtype=dtype, device=device)
    return t.requires_grad_() if dtype.is_floating_point else t


WRAPPER_ARGS = {  # name: device -> the wrapper's positional arguments
    "flash_attention": lambda d: (_t(d, (1, 4, 2, 8)), _t(d, (1, 4, 2, 8)), _t(d, (1, 4, 2, 8))),
    "flash_attention_bwd": lambda d: (_t(d, (1, 4, 2, 8)), _t(d, (1, 4, 2, 8)),
                                      _t(d, (1, 4, 2, 8)), _t(d, (1, 4, 2, 8)),
                                      _t(d, (1, 4, 2)), _t(d, (1, 4, 2, 8))),
    "flash_decode": lambda d: (_t(d, (1, 1, 2, 8)), _t(d, (1, 4, 2, 8)), _t(d, (1, 4, 2, 8)),
                               _t(d, (1, 4), torch.int32), _t(d, (1,), torch.int32)),
    "flash_decode_chunk": lambda d: (_t(d, (1, 2, 2, 8)), _t(d, (1, 4, 2, 8)),
                                     _t(d, (1, 4, 2, 8)), _t(d, (1, 4), torch.int32),
                                     _t(d, (1,), torch.int32)),
    "flash_decode_paged": lambda d: (_t(d, (1, 1, 2, 8)), _t(d, (2, 4, 2, 8)),
                                     _t(d, (2, 4, 2, 8)), _t(d, (2, 4), torch.int32),
                                     _t(d, (1, 2), torch.int32), _t(d, (1,), torch.int32)),
    "linear": lambda d: (_t(d, (2, 8)), _t(d, (8, 4))),
    "rms_norm": lambda d: (_t(d, (2, 8)), _t(d, (8,)), 1e-6),
    "layer_norm": lambda d: (_t(d, (2, 8)), _t(d, (8,)), _t(d, (8,)), 1e-5),
    "moe_gemm": lambda d: (_t(d, (2, 8, 8)), _t(d, (2, 8, 8)), _t(d, (2,), torch.int32)),
    "rglru_scan": lambda d: (_t(d, (1, 4, 8)), _t(d, (1, 4, 8)), _t(d, (1, 8))),
    "ssm_scan": lambda d: (_t(d, (1, 4, 8)), _t(d, (1, 4, 8)), _t(d, (1, 4, 2)),
                           _t(d, (1, 4, 2)), _t(d, (8, 2)), _t(d, (1, 8, 2))),
}


def test_every_public_wrapper_is_walked():
    """A wrapper added to kernels/ops.py later must join WRAPPER_ARGS."""
    from repro_torch.kernels import ops

    public = {n for n, f in vars(ops).items() if callable(f) and not n.startswith("_")
              and getattr(f, "__module__", "").startswith("repro_torch.kernels")}
    assert public - NOT_WRAPPERS == set(WRAPPER_ARGS)


@pytest.mark.parametrize("name", list(WRAPPER_ARGS))
def test_wrapper_refuses_autograd_off_the_cpu(name):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    fn = getattr(ops, name)
    args = WRAPPER_ARGS[name]("meta")
    if name == "flash_attention":
        with pytest.raises(ValueError, match="cuda or cpu"):  # through the Function
            fn(*args)
        with pytest.raises(RuntimeError, match="no backward"):
            fa._flash_attention_cuda(*args, causal=True, window=0, q_offset=0, prefix_len=0,
                                     block_q=64, block_k=fa.BLOCK_K)
    else:
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)
    with torch.no_grad():
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(*args)
    # CPU tensors that require grad take the plain version: no refusal.
    out = fn(*WRAPPER_ARGS[name]("cpu"))
    assert (out[0] if isinstance(out, tuple) else out).requires_grad


def test_function_prefix_backward_needs_a_whole_sequence():
    """The prefix-LM recompute covers Sq = Sk at offset 0 (the train
    path's): another call's backward raises rather than mask wrongly."""
    q = torch.zeros((1, 8, 2, 8), requires_grad=True)
    k = torch.zeros((1, 16, 2, 8), requires_grad=True)
    out = flash_attention(q, k, k, causal=True, q_offset=8, prefix_len=4)
    with pytest.raises(ValueError, match="whole sequence"):
        out.sum().backward()
