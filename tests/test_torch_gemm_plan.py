"""The launch plans of the port's row-invariant kernels, on the CPU: what
``kernels/gemm.py:plan`` and ``operands`` and ``kernels/rms_norm.py:plan``
hand the CUDA kernels, which the card's checks (chip_smoke.py) then hold
bitwise.

The contract is that a row's bits do not depend on the batch around it, so
the order of every sum may depend on the shape of the weight (K, N) but
never on M: the GEMM's K chain (k16 steps, splits) is the same at every M
and through every route, and the norm's order is set by d alone.  The JAX
reference is not involved: these are the port's own launch decisions.
The product shapes are the four families' full-width ones, taken from the
configs as the models' call sites build them, and the layouts are those
the reduced models hand ``linear`` in a prefill and a decode step."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import gemm, ops
from repro_torch.kernels import rms_norm as rn
from repro_torch.models import get_model
from repro_torch.models.params import materialize
from repro_torch.serve import zeros_cache

MS = (1, 2, 3, 8, 16, 63, 64, 65, 127, 128, 300, 600, 2048, 4096)
ARCHS = ("qwen1.5-4b", "internlm2-20b", "falcon-mamba-7b", "recurrentgemma-2b")


def full_products(cfg):
    """(K, N, wt, batch) of every product of one forward at full width:
    attention's q, k, v and o (``attention._proj``, ``_out_proj``), the
    gated MLP's gate, up and down (``layers.swiglu``, ``geglu``), Mamba's
    in_proj, x_proj, dt_proj and out_proj (``mamba.py``), the recurrent
    block's in_y, in_x, the block-diagonal gates and out (``rglru.py``),
    and the head (``transformer.logits_fn``; a tied head reads the (N, K)
    embedding table, wt = 1)."""
    d = cfg.d_model
    head = [(d, cfg.vocab, int(cfg.tie_embeddings), 1)]
    if cfg.family == "ssm":
        di, rank = cfg.ssm_expand * d, -(-d // 16)
        return [(d, 2 * di, 0, 1), (di, rank + 2 * cfg.ssm_state, 0, 1), (rank, di, 0, 1),
                (di, d, 0, 1)] + head
    attn = [(d, cfg.n_heads * cfg.hd, 0, 1), (d, cfg.n_kv_heads * cfg.hd, 0, 1),
            (cfg.n_heads * cfg.hd, d, 0, 1)]
    mlp = [(d, cfg.d_ff, 0, 1), (cfg.d_ff, d, 0, 1)]
    if cfg.family == "dense":
        return attn + mlp + head
    w, nb = cfg.lru_width, cfg.n_heads
    return [(d, w, 0, 1), (w // nb, w // nb, 0, nb), (w, d, 0, 1)] + attn + mlp + head


def test_falcon_mamba_full_products_match_the_chip_cases():
    """The table above gives the widths the card's cases time: in_proj
    (4096, 16384), x_proj (8192, 288), dt_proj (256, 8192)."""
    got = full_products(get_config("falcon-mamba-7b"))
    assert {(4096, 16384, 0, 1), (8192, 288, 0, 1), (256, 8192, 0, 1)} <= set(got)
    assert (256, 256, 0, 10) in full_products(get_config("recurrentgemma-2b"))
    assert (2560, 256000, 1, 1) in full_products(get_config("recurrentgemma-2b"))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("aligned", [True, False])
def test_k_chain_is_the_same_at_every_m(arch, aligned):
    """The K chain of each full-width product is one function of (K, N):
    the same k16 steps, unsplit, at every M, whichever route M picks."""
    for k, n, wt, batch in full_products(get_config(arch)):
        plans = [gemm.plan(m, n, k, wt, aligned, batch=batch) for m in MS]
        assert {p.chain for p in plans} == {("k16", -(-k // 16), 1)}, (k, n)
        routes = {p.route for p in plans}
        assert routes <= ({"wide", "narrow", "gemv", "head"} if aligned else {"plain"})


@pytest.mark.parametrize("k", [36, 100, 264])
@pytest.mark.parametrize("n", [8, 100, 288, 1000, 40000])
def test_odd_k_chain_is_the_same_at_every_m(k, n):
    chains = {gemm.plan(m, n, k, 0, aligned).chain for m in MS for aligned in (True, False)}
    assert chains == {("k16", -(-k // 16), 1)}


@pytest.mark.parametrize("k", [1, 15, 16, 17, 64, 65, 2560, 6912, 8192])
def test_k16_steps_are_ceil_k_over_16_on_every_route(k):
    """Every bf16 route runs ceil(K/16) k16 steps (a partial last step
    reads zeros past K; steps wholly past K are skipped); float32 runs K
    FMAs.  The route table covers every route the kernel takes."""
    seen = set()
    for m in MS:
        for n in (32, 288, 7680, 151936):
            for aligned in (True, False):
                p = gemm.plan(m, n, k, 0, aligned)
                seen.add(p.route)
                assert p.chain == ("k16", -(-k // 16), 1)
                assert p.tile == gemm.TILES[p.route][0] and p.stages == gemm.TILES[p.route][1]
                assert p.tile[2] % 16 == 0
        f32 = gemm.plan(m, 288, k, 0, True, dtype=torch.float32)
        assert (f32.route, f32.chain) == ("f32", ("fma", k, 1))
    assert seen == set(gemm.ROUTES) - {"f32"}


def test_route_follows_m_and_n_only_where_the_plan_says():
    """Prefill products take the wide tile once it fills the card's SMs;
    x_proj's N 288 keeps the narrow one; decode takes gemv, or the
    128-wide head tile for the vocabularies; operands TMA cannot read take
    the plain loads."""
    assert gemm.plan(2048, 6912, 2560, 0, True).route == "wide"
    assert gemm.plan(2048, 256, 256, 0, True, batch=10).route == "wide"
    assert gemm.plan(2048, 288, 8192, 0, True).route == "narrow"
    assert gemm.plan(300, 2560, 2560, 0, True).route == "narrow"
    assert gemm.plan(8, 7680, 2560, 0, True).route == "gemv"
    assert gemm.plan(64, 2560, 6912, 0, True).route == "gemv"
    assert gemm.plan(65, 2560, 6912, 0, True).route == "narrow"
    assert gemm.plan(8, 151936, 2560, 0, True).route == "head"
    assert gemm.plan(8, 256000, 2560, 1, True).route == "head"
    assert gemm.plan(2048, 6912, 2560, 0, False).route == "plain"
    p = gemm.plan(2048, 6912, 2560, 0, True)
    assert p.describe() == "wide 128x256x64, 4 stages, chain 160 x k16 ascending, 1 split"


def recorded_operands(arch):
    """``gemm.operands`` of every product a reduced model hands ``linear``
    in one prefill and one decode step under kernel_impl="cuda"."""
    seen = []
    real = ops.linear

    def linear(x, w, bias=None):
        seen.append(gemm.operands(x, w, bias))
        return real(x, w, bias)

    cfg = dataclasses.replace(reduced(get_config(arch)), kernel_impl="cuda")
    api = get_model(cfg)
    cpu = torch.device("cpu")
    params = materialize(api.param_spec(cfg), torch.Generator().manual_seed(0),
                         torch.float32, cpu)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
                              .astype(np.int32))
    cache = zeros_cache(cfg, api, 2, 10, device=cpu)
    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "linear", linear)
    try:
        logits, cache = api.prefill(params, {"tokens": tokens}, cfg, cache)
        api.decode(params, logits.argmax(-1).int(), 8, cfg, cache)
    finally:
        mp.undo()
    return cfg, seen


@pytest.mark.parametrize("arch", ARCHS)
def test_every_model_layout_is_tma_eligible(arch):
    """Every product the reduced models hand over -- strided views, the
    last position's rows, the tied (N, K) head, the block-diagonal gates
    -- is read by TMA wherever its K and N are multiples of 8: no view
    the models make falls to the plain loads for its strides or pointers.
    (The reduced falcon-mamba's x_proj and dt_proj have N 20 and K 4, so
    they take the plain loads here; at full width they are 288 and 256.)"""
    cfg, seen = recorded_operands(arch)
    assert seen
    assert all(o["tma"] for o in seen if o["k"] % 8 == 0 and o["n"] % 8 == 0), [
        (o["m"], o["k"], o["n"], o["lda"]) for o in seen if not o["tma"]]
    if cfg.family == "ssm":  # dt_proj reads x_proj's output, rows R + 2N apart
        assert any(o["lda"] > o["k"] and o["m"] > 1 for o in seen)
    else:
        assert all(o["tma"] for o in seen)
    if cfg.family == "hybrid":
        assert any(o["batch"] == cfg.n_heads for o in seen)  # the gates, one launch
        assert any(o["wt"] == 1 for o in seen)  # the tied head


def test_tma_eligibility_of_the_layouts_at_full_width():
    """The same layouts at the chip's widths, and the odd ones that must
    take the plain loads: K or N not a multiple of 8, a row stride not a
    multiple of 8 elements, a base pointer off 16 bytes."""
    bf = torch.bfloat16
    xdb = torch.zeros(2, 5, 288, dtype=bf)  # x_proj's output
    dt = torch.split(xdb, [256, 16, 16], dim=-1)[0]
    o = gemm.operands(dt, torch.zeros(256, 8192, dtype=bf))
    assert (o["lda"], o["tma"]) == (288, True)
    h = torch.zeros(8, 9, 2560, dtype=bf)  # the head reads the last position
    o = gemm.operands(h[:, -1:], torch.zeros(2560, 64, dtype=bf))
    assert (o["m"], o["lda"], o["tma"]) == (8, 9 * 2560, True)
    embed = torch.zeros(1000, 2560, dtype=bf)  # a tied head
    o = gemm.operands(torch.zeros(3, 2560, dtype=bf), embed.T)
    assert (o["wt"], o["tma"]) == (1, True)
    o = gemm.operands(torch.zeros(2, 7, 10, 256, dtype=bf), torch.zeros(10, 256, 256, dtype=bf),
                      torch.zeros(10, 256, dtype=bf))
    assert (o["batch"], o["sx"], o["tma"]) == (10, 256, True)
    assert not gemm.operands(torch.zeros(5, 36, dtype=bf), torch.zeros(36, 100, dtype=bf))["tma"]
    assert not gemm.operands(torch.zeros(5, 64, dtype=bf), torch.zeros(64, 100, dtype=bf))["tma"]
    wide = torch.zeros(5, 65, dtype=bf)
    assert not gemm.operands(wide[:, :64], torch.zeros(64, 96, dtype=bf))["tma"]
    buf = torch.zeros(5 * 64 + 8, dtype=bf)
    assert buf.data_ptr() % 16 == 0
    assert not gemm.operands(buf[1:1 + 5 * 64].view(5, 64), torch.zeros(64, 96, dtype=bf))["tma"]
    assert gemm.operands(buf[8:8 + 5 * 64].view(5, 64), torch.zeros(64, 96, dtype=bf))["tma"]


@pytest.mark.parametrize("d", [1, 7, 8, 255, 256, 300, 2560, 4096, 4097, 6144, 8192])
def test_rms_norm_plan_depends_on_d_alone(d):
    """Chunks of 8, lane l owning chunks l, l + 32, ...: the plan is a
    function of d alone (it takes nothing else), and the register-held
    instance covers every lane's chunks, or d takes the two-pass loop."""
    p = rn.plan(d)
    assert p == rn.plan(int(d))
    assert p["chunks"] == -(-d // 8) and p["per_lane"] == -(-p["chunks"] // 32)
    if p["vpl"]:
        assert p["vpl"] in rn.VPL and p["vpl"] >= p["per_lane"]
        assert all(v < p["per_lane"] for v in rn.VPL if v < p["vpl"])
    else:
        assert p["per_lane"] > max(rn.VPL)


def test_rms_norm_plan_of_the_models():
    assert rn.plan(2560)["vpl"] == 10 and rn.plan(4096)["vpl"] == 16
    for arch in ARCHS:
        d = get_config(arch).d_model
        assert rn.plan(d)["per_lane"] == -(-d // 256)
