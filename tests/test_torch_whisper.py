"""The port's audio family (whisper-tiny) vs the JAX package.

Reduced whisper-tiny (d 64, 4 heads of 16, 2 encoder and 2 decoder layers,
12 frames, a context cap of 32) with JAX parameters loaded by
``load_jax_params``; numpy-seeded frames and tokens.  The port's
"reference" is held against the JAX "reference", the port's "cuda" (CPU
tensors: the kernels' plain versions) against the JAX "pallas_interpret".
float32 at 1e-4 (XLA and torch order float32 sums differently); the
``layer_norm`` kernel's plain version also in bfloat16, at 2e-2 relative L2.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import get_model as jax_get_model
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import whisper as jwhisper
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as kops
from repro_torch.kernels.layer_norm import layer_norm_plain
from repro_torch.launch import serve as tlaunch
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import params as tparams
from repro_torch.models import whisper as W
from repro_torch.serve import graphs, make_generate, zeros_cache
from repro_torch.serve import step as tstep

TOL = 1e-4
BF16_REL = 2e-2
IMPLS = [("reference", "reference"), ("cuda", "pallas_interpret")]


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t, np.float32), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _rel(t, j):
    t, j = np.asarray(t, np.float32), np.asarray(j, np.float32)
    return float(np.linalg.norm(t - j) / np.linalg.norm(j))


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.reduced(jconfigs.get_config("whisper-tiny"))
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1), jax.random.PRNGKey(0),
                             jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get_config("whisper-tiny"))
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _cfgs(weights, timpl, jimpl):
    jcfg, jp, tcfg, tp = weights
    return (dataclasses.replace(jcfg, kernel_impl=jimpl), jp,
            dataclasses.replace(tcfg, kernel_impl=timpl), tp)


def _batch(cfg, b=2, s=5, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "frames": rng.normal(size=(b, cfg.enc_frames, cfg.d_model)).astype(np.float32)}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [384, 64, 100])
def test_layer_norm_plain_matches_jax(d, dtype):
    """``layer_norm_plain`` (and the wrapper on CPU tensors) against the JAX
    package's ``layers.layer_norm``: mean, the centred variance, the cast
    before the scale and shift."""
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(3, 7, d)) * 2 + 0.5).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    b = rng.normal(size=(d,)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jlayers.layer_norm(*(jnp.asarray(a, jdt) for a in (x, w, b)), 1e-5)
    tx, tw, tb = (torch.from_numpy(a).to(tdt) for a in (x, w, b))
    got = layer_norm_plain(tx, tw, tb, 1e-5)
    assert got.dtype == tdt and torch.equal(kops.layer_norm(tx, tw, tb, 1e-5), got)
    assert torch.equal(L.layer_norm(tx, tw, tb, 1e-5, "cuda"), got)
    if dtype == "float32":
        _close(got, want)
    else:
        assert _rel(got.float(), np.asarray(want, np.float32)) < BF16_REL


def test_layer_norm_wrapper_refuses_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kops.layer_norm(x, x[0], x[0], 1e-5)


def test_sinusoids_match_jax(weights):
    _, _, tcfg, _ = weights
    for length, ch in ((tcfg.enc_frames, tcfg.d_model), (1500, 384)):
        assert torch.equal(W.sinusoids(length, ch),
                           torch.from_numpy(np.array(jwhisper.sinusoids(length, ch))))


def test_load_jax_params_keeps_the_tree(weights):
    jcfg, jp, tcfg, tp = weights
    spec = get_model(tcfg).param_spec(tcfg)
    assert sorted(tp) == sorted(jp) == sorted(spec)
    for t, j in zip(tparams.tree_leaves(tp), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jp), is_leaf=lambda x: isinstance(x, np.ndarray))):
        assert tuple(t.shape) == j.shape
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    np_tree["pos_embed"] = np_tree["pos_embed"][:-1]
    with pytest.raises(ValueError, match="pos_embed"):
        tparams.load_jax_params(np_tree, tcfg, "cpu")


@pytest.mark.parametrize("timpl,jimpl", IMPLS)
def test_gelu_mlp_matches_jax(weights, timpl, jimpl):
    _, jp, _, tp = weights
    m_j = jax.tree_util.tree_map(lambda a: a[0], jp["dec_layers"]["mlp"])
    m_t = {k: v[0] for k, v in tp["dec_layers"]["mlp"].items()}
    x = np.random.default_rng(2).normal(size=(2, 5, m_t["w_in"].shape[0])).astype(np.float32)
    want = jlayers.gelu_mlp(jnp.asarray(x), m_j["w_in"], m_j["b_in"], m_j["w_out"], m_j["b_out"])
    got = L.gelu_mlp(torch.from_numpy(x), m_t["w_in"], m_t["b_in"], m_t["w_out"], m_t["b_out"],
                     timpl)
    _close(got, want)


@pytest.mark.parametrize("timpl,jimpl", IMPLS)
def test_encode_matches_jax(weights, timpl, jimpl):
    jcfg, jp, tcfg, tp = _cfgs(weights, timpl, jimpl)
    frames = _batch(tcfg)["frames"]
    want = jwhisper.encode(jp, jnp.asarray(frames), jcfg)
    _close(W.encode(tp, torch.from_numpy(frames), tcfg), want)


@pytest.mark.parametrize("timpl,jimpl", IMPLS)
def test_prefill_and_decode_match_jax(weights, timpl, jimpl):
    """Prefill logits and every cache leaf, then three decode steps at
    per-slot (vector) positions, slot 1 a step ahead of slot 0 (its cache
    holds a hole there, masked on both sides)."""
    jcfg, jp, tcfg, tp = _cfgs(weights, timpl, jimpl)
    japi, tapi = jax_get_model(jcfg), get_model(tcfg)
    b, s, gen = 2, 5, 4
    batch = _batch(tcfg, b, s)
    jl, jc = japi.prefill(jp, _jax_batch(batch), jcfg, jserve.zeros_cache(jcfg, japi, b, s + gen))
    tc = zeros_cache(tcfg, tapi, b, s + gen, device="cpu")
    tl, tc2 = tapi.prefill(tp, _torch_batch(batch), tcfg, tc)
    assert tc2 is tc  # written in place
    assert tl.shape == (b, 1, tcfg.vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    jleaves, tleaves = jax.tree_util.tree_leaves(jc), tparams.tree_leaves(tc)
    assert len(jleaves) == len(tleaves) == 5
    for t, j in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape
        _close(t, j)
    rng = np.random.default_rng(5)
    for i in range(3):
        tok = rng.integers(0, tcfg.vocab, (b, 1)).astype(np.int32)
        pos = np.array([s + i, s + i + 1], np.int32)
        jl, jc = japi.decode(jp, jnp.asarray(tok), jnp.asarray(pos), jcfg, jc)
        tl, tc = tapi.decode(tp, torch.from_numpy(tok), torch.from_numpy(pos), tcfg, tc)
        _close(tl, jl)
        for t, j in zip(tparams.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
            _close(t, j)


@pytest.mark.parametrize("timpl,jimpl", IMPLS)
def test_make_generate_matches_jax(weights, timpl, jimpl):
    jcfg, jp, tcfg, tp = _cfgs(weights, timpl, jimpl)
    japi, tapi = jax_get_model(jcfg), get_model(tcfg)
    batch = _batch(tcfg, 3, 6, seed=7)
    want = np.asarray(jserve.make_generate(jcfg, japi)(jp, _jax_batch(batch), 6))
    got = make_generate(tcfg, tapi)(tp, _torch_batch(batch), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_refuses_past_the_context_cap(weights):
    _, _, tcfg, tp = weights
    batch = _torch_batch(_batch(tcfg, 1, 30))
    with pytest.raises(ValueError, match="max_decode_ctx"):
        make_generate(tcfg, get_model(tcfg))(tp, batch, tcfg.max_decode_ctx - 29)


class CPUReplay(graphs.GraphCache):
    """A GraphCache that "captures" on the CPU: the loop runs once on clones
    of its static buffers, and a replay reruns it on the static buffers
    themselves, copying its results into the captured outputs."""

    @staticmethod
    def accepts(device):
        return True

    def _record(self, statics, body):
        outputs = body(graphs._rebuild(statics, lambda r, i, s: s.clone()))

        class Replay:
            @staticmethod
            def replay():
                for o, r in zip(outputs, body(statics)):
                    o.copy_(r)

        return Replay(), outputs, {}


def test_replayed_generate_reads_each_calls_frames(weights, monkeypatch):
    """The prefill graph takes the frames as a static input copied in each
    call: two calls of one shape on different frames give each its own
    eager tokens, each call copying in the tokens and the frames."""
    _, _, tcfg, tp = _cfgs(weights, "cuda", "pallas_interpret")
    tapi = get_model(tcfg)
    batches = [_torch_batch(_batch(tcfg, 2, 5, seed=s)) for s in (11, 12)]
    batches[1]["tokens"] = batches[0]["tokens"]  # only the frames differ
    eager = [make_generate(tcfg, tapi, graph=False)(tp, b, 4) for b in batches]
    assert not torch.equal(eager[0], eager[1])
    monkeypatch.setattr(tstep, "GraphCache", CPUReplay)
    replayed = make_generate(tcfg, tapi)
    assert replayed.prepare(tp, batches[0], 4) > 0.0
    copies = []
    for b, want in zip(batches, eager):
        assert torch.equal(replayed(tp, b, 4), want)
        copies.append(replayed.graphs.copy_ins - sum(copies))
    assert copies == [2, 2]
    assert replayed.graphs.stats()["captures"] == 2


@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b"])
def test_launcher_oneshot_and_coexec_verify_on_cpu(arch):
    argv = ["--arch", arch, "--device", "cpu", "--requests", "4", "--prompt-len", "6",
            "--gen", "4"]
    res = tlaunch.main(argv)
    assert res["tokens"].shape == (4, 4)
    res = tlaunch.main(argv + ["--coexec", "--verify", "--scheduler", "hguided"])
    assert res["verified"] and res["tokens"].shape == (4, 4)
    assert all(res["packages"].values())


@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b"])
def test_server_refuses_the_family(arch):
    from repro_torch.core import DeviceGroup
    from repro_torch.serve import InferenceServer

    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    extra = "frames" if cfg.family == "audio" else "patches"
    with pytest.raises(ValueError, match=f"'{extra}'"):
        InferenceServer(cfg, get_model(cfg), {}, groups=[DeviceGroup("cpu0", device="cpu")])
    with pytest.raises(ValueError, match="cannot be served"):
        tlaunch.main(["--arch", arch, "--device", "cpu", "--server"])
