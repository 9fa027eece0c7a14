"""flash_attention's backward (``kernels/flash_attention.py``): the plain
version of the CUDA kernel, ``flash_attention_bwd_plain``, fed by the plain
forward's output and log-sum-exp, against ``jax.vjp`` of the JAX package's
``flash_attention`` (Pallas, interpret mode; its VJP recomputes attention in
``jnp``) and of its ``_prefix_lm_attention``, on the same numpy-seeded q, k,
v and dO.  float32 at 2e-5, the tolerance of the reference suite's float32
gradients (``GRAD_TOL`` in tests/test_torch_flash_attention.py).

Also: the inverse tile range (the dk/dv walk's q tiles) equal to the set of
q tiles whose forward tile range reaches a key tile, exhaustively on small
shapes; ``backward_plan`` on the train paths' shapes and on shapes it must
refuse; the saved log-sum-exp; keys no row reaches get zero gradients."""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ops import flash_attention as jax_flash_attention
from repro.models.attention import _prefix_lm_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import flash_attention_bwd, launch_counts, reset_launch_counts

GRAD_TOL = 2e-5

CASES = {  # b, sq, sk, h, kv, hd, causal, window, q_offset
    "causal": (1, 128, 128, 2, 2, 32, True, 0, 0),
    "mqa": (2, 96, 96, 4, 1, 32, True, 0, 0),
    "gqa": (1, 128, 128, 6, 2, 16, True, 0, 0),
    "qoffset": (1, 48, 176, 4, 2, 32, True, 0, 128),
    "window": (1, 160, 160, 4, 2, 32, True, 40, 0),
    "window-qoffset": (1, 64, 200, 2, 1, 32, True, 48, 136),
    "bidirectional-cross": (2, 40, 150, 3, 3, 32, False, 0, 0),  # Sq != Sk, Sk % 64 != 0
    "bidirectional": (1, 100, 100, 2, 2, 64, False, 0, 0),
    "unaligned": (1, 150, 150, 4, 4, 32, True, 0, 0),  # Sk not a multiple of the tile
}


def inputs(case, seed):
    b, sq, sk, h, kv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32)
            for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd), (b, sq, h, hd))]


def port_bwd(q, k, v, do, **kw):
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    return out, fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, **kw)


def close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax_vjp(name):
    case = CASES[name]
    causal, window, qoff = case[6:]
    q, k, v, do = inputs(case, seed=len(name))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    _, got = port_bwd(q, k, v, do, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, block_q=64, block_k=64,
                                                         interpret=True, **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    close(got, vjp(jnp.asarray(do)))


@pytest.mark.parametrize("prefix,window,kv", [(48, 0, 1), (96, 0, 2), (40, 32, 2)],
                         ids=["mqa-p48", "gqa-p96", "window32-p40"])
def test_plain_prefix_backward_matches_jax_vjp(prefix, window, kv):
    """The prefix-LM mode against jax.vjp of the JAX package's
    ``_prefix_lm_attention``, PaliGemma's prefill (plain jnp there)."""
    q, k, v, do = inputs((2, 128, 128, 4, kv, 32), seed=prefix)
    out, got = port_bwd(q, k, v, do, causal=True, window=window, prefix_len=prefix)
    want, vjp = jax.vjp(lambda a, b, c: _prefix_lm_attention(a, b, c, None, prefix, window),
                        *(jnp.asarray(x) for x in (q, k, v)))
    close([out], [want])
    close(got, vjp(jnp.asarray(do)))


@pytest.mark.parametrize("name", ["gqa", "window-qoffset", "bidirectional-cross"])
def test_function_backward_is_the_plain_backward(name):
    """On CPU tensors the autograd Function's backward is
    flash_attention_bwd_plain on its saved output and log-sum-exp, bit for
    bit, and launches nothing."""
    case = CASES[name]
    causal, window, qoff = case[6:]
    q, k, v, do = inputs(case, seed=3)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    reset_launch_counts()
    out = fa.flash_attention(tq, tk, tv, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _, want = port_bwd(q, k, v, do, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.parametrize("block_q,block_k", [(32, 64), (64, 32), (128, 128)])
def test_plain_backward_tiling_does_not_change_the_function(block_q, block_k):
    """Tile sizes change only which all-masked tiles are skipped and the
    order of the float32 sums."""
    case = CASES["window-qoffset"]
    q, k, v, do = inputs(case, seed=5)
    kw = dict(causal=True, window=48, q_offset=136)
    _, base = port_bwd(q, k, v, do, **kw)
    _, got = port_bwd(q, k, v, do, block_q=block_q, block_k=block_k, **kw)
    for g, w in zip(got, base):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_plain_lse_is_the_rows_logsumexp():
    """The forward's saved log-sum-exp, in base 2, is each row's logsumexp
    of its scaled, masked scores; asking for it leaves the output's bits as
    they are."""
    b, sq, sk, h, kv, hd = 1, 70, 200, 4, 2, 32
    q, k, v, _ = inputs((b, sq, sk, h, kv, hd), seed=9)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(causal=True, window=64, q_offset=120)
    out, lse = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    assert torch.equal(out, fa.flash_attention_plain(tq, tk, tv, **kw))
    kr = tk.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", tq.double(), kr.double()) * hd ** -0.5
    valid = fa._valid(120 + torch.arange(sq), torch.arange(sk), True, 64, 0)
    s = s.masked_fill(~valid, float("-inf"))
    want = torch.logsumexp(s, dim=-1).transpose(1, 2)
    got = lse.double() * np.log(2.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-6)


PEAKED_TOL = 1e-4  # float32 against float64 in peaked rows; the JAX VJP reads 1.3e-5 here


def test_peaked_rows_with_large_scores_keep_their_precision():
    """Rows whose scores are large (q a large multiple of the keys' shared
    direction) and whose attention is peaked (mean row max P 0.999): each
    row's D is divided by the sum of its recomputed P, so every row's dS sums
    to zero and the float32 plain backward stays within PEAKED_TOL of
    float64 autograd, as the JAX package's VJP does.  D = rowsum(P dP) alone
    takes the lse's rounding at the row's large scores into every dS of the
    row, 1e-3 off float64 here."""
    b, s, h, kv, hd = 1, 64, 2, 1, 32
    rng = np.random.default_rng(1)
    u = rng.standard_normal(hd).astype(np.float32)
    u /= np.linalg.norm(u)
    q = (300 * u + 0.1 * rng.standard_normal((b, s, h, hd))).astype(np.float32)
    k = (u + 0.5 * rng.standard_normal((b, s, kv, hd))).astype(np.float32)
    v, do = (rng.standard_normal(sh).astype(np.float32) for sh in ((b, s, kv, hd), (b, s, h, hd)))
    _, got = port_bwd(q, k, v, do, causal=True)
    qd, kd, vd = (torch.from_numpy(x).double().requires_grad_() for x in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", qd, kd.repeat_interleave(h // kv, 2)) * hd ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    assert float(p.detach().amax(-1).mean()) > 0.998
    out = torch.einsum("bhqk,bkhd->bqhd", p, vd.repeat_interleave(h // kv, 2))
    want = torch.autograd.grad(out, (qd, kd, vd), torch.from_numpy(do).double())
    for g, w in zip(got, want):
        assert float((g.double() - w).norm() / w.norm()) < PEAKED_TOL


def test_unreached_keys_get_zero_gradients():
    """Keys past the last row's causal limit, and before the first row's
    window, are reached by no row: their dk and dv are exact zeros."""
    q, k, v, do = inputs((1, 64, 256, 2, 1, 32), seed=11)
    _, (_, dk, dv) = port_bwd(q, k, v, do, causal=True, window=32, q_offset=100)
    reached = torch.zeros(256, dtype=torch.bool)
    reached[100 - 31:100 + 64] = True
    for g in (dk, dv):
        assert torch.all(g[:, ~reached] == 0)
        assert torch.all(g[:, reached].abs().sum(dim=(0, 2, 3)) > 0)


# Small shapes walked exhaustively: every key tile's inverse range equals the
# q tiles whose forward _tile_range reaches it.
INVERSE_SHAPES = list(itertools.product(
    [(1, 17), (3, 40), (10, 64)],       # (div, positions): rows are div x positions
    [40, 64, 97],                       # sk
    [(True, 0, 0), (True, 16, 0), (True, 0, 24), (True, 16, 24), (False, 0, 0),
     (False, 16, 0), (True, 1, 8)],     # causal, window, prefix
    [0, 30]))                           # q_offset


@pytest.mark.parametrize("shape", [INVERSE_SHAPES[i::8] for i in range(8)],
                         ids=[f"part{i}" for i in range(8)])
def test_inverse_tile_range_is_exact(shape):
    for (div, pos), sk, (causal, window, prefix), q_offset in shape:
        if prefix and (q_offset or pos != sk):
            continue  # the prefix-LM backward's domain: a whole sequence
        n_rows = div * pos
        for bq, bk in ((8, 16), (16, 32), (64, 64), (32, 8)):
            def reach(i):
                r0 = i * bq
                return fa._tile_range(q_offset + r0 // div,
                                      q_offset + (min(r0 + bq, n_rows) - 1) // div, sk, bk,
                                      causal, window, prefix)
            for t in range(-(-sk // bk)):
                want = [i for i in range(-(-n_rows // bq))
                        if reach(i)[0] <= t < reach(i)[1]]
                lo, hi = fa._inverse_tile_range(t, n_rows, bq, bk, sk, causal, window,
                                                q_offset, prefix, div)
                assert list(range(lo, hi)) == want, (div, pos, sk, causal, window, prefix,
                                                     q_offset, bq, bk, t)


# The train paths' shapes (chip_smoke.py's TRAIN_ATTENTION and whisper's
# cross-attention), and the mesh's float32 train step: b, sq, sk, h, kv, hd,
# dtype, prefix, the route they must take.
TRAIN_SHAPES = {
    "qwen1.5-4b (B 2, 512, causal)": (2, 512, 512, 20, 20, 128, "bfloat16", 0, "mma"),
    "whisper-tiny encoder (B 8, 1500)": (8, 1500, 1500, 6, 6, 64, "bfloat16", 0, "mma"),
    "whisper-tiny cross (B 8, 64 over 1500)": (8, 64, 1500, 6, 6, 64, "bfloat16", 0, "mma"),
    "paligemma-3b prefix (B 8, 288, P 256)": (8, 288, 288, 8, 1, 256, "bfloat16", 256, "mma"),
    "recurrentgemma-2b local (B 2, 4096)": (2, 4096, 4096, 10, 1, 256, "bfloat16", 0, "mma"),
    "qwen1.5-4b float32 (mesh c, e)": (2, 512, 512, 20, 20, 128, "float32", 0, "fma"),
    "kimi hd 112 (bf16, FMA route)": (2, 256, 256, 64, 8, 112, "bfloat16", 0, "fma"),
}


@pytest.mark.parametrize("name", list(TRAIN_SHAPES))
def test_backward_plan_admits_train_shapes(name):
    from repro_torch.kernels import _build

    b, sq, sk, h, kv, hd, dtype, prefix, route = TRAIN_SHAPES[name]
    plan = fa.backward_plan(b, sq, sk, h, kv, hd, getattr(torch, dtype))
    assert plan["route"] == route
    for pas in (plan["dq"], plan["dkdv"]):
        assert pas["smem"] <= _build.MAX_SMEM and pas["grid"][1] <= 65535
    dkdv = plan["dkdv"]
    if route == "mma":
        g = fa.heads_per_block(h // kv)
        # The dq pass has the forward's rows and grid; the dk/dv pass one
        # block a (batch, kv head, key tile).
        assert plan["dq"]["grid"] == fa.launch_plan(b, sq, sk, h, kv, hd, torch.bfloat16,
                                                    prefix_len=prefix)["grid"]
        assert plan["dq"]["heads_per_block"] == g
        assert dkdv["block_k"] == (32 if hd == 256 else 64)
        assert dkdv["grid"] == (b * kv, -(-sk // dkdv["block_k"]))
    else:
        assert dkdv["grid"] == (-(-sk // 32), b * kv)


@pytest.mark.parametrize("args,match", [
    ((1, 64, 64, 4, 3, 128, torch.bfloat16), "multiple of KV"),
    ((1, 64, 64, 4, 4, 1024, torch.float32), "too wide"),
    ((1, 64, 64, 4, 4, 6, torch.float32), "16-byte"),
    ((1, 64, 64, 4, 4, 128, torch.float16), "float32 or bfloat16"),
    ((70000, 64, 64, 1, 1, 128, torch.float32), "65535"),
    ((1, 70000 * 64, 64, 2, 1, 128, torch.bfloat16), "65535"),
], ids=["gqa-ratio", "f32-too-wide", "unaligned-rows", "fp16", "grid", "dq-grid"])
def test_backward_plan_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        fa.backward_plan(*args)


@pytest.mark.parametrize("sq,sk,q_offset", [(8, 16, 8), (8, 8, 4)], ids=["cross", "offset"])
def test_backward_refuses_the_prefix_outside_a_whole_sequence(sq, sk, q_offset):
    """The wrapper keeps the reference's prefix-LM domain (Sq = Sk at
    offset 0), on the CPU as on the card."""
    q = torch.zeros((1, sq, 2, 8))
    k = torch.zeros((1, sk, 2, 8))
    lse = torch.zeros((1, sq, 2))
    with pytest.raises(ValueError, match="whole sequence"):
        flash_attention_bwd(q, k, k, q, lse, q, causal=True, q_offset=q_offset, prefix_len=4)
