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
