"""The port's device mesh on gloo worlds of CPU ranks (``spawn_world``):
the seq-sharded decode combine against the JAX package's unsharded
decode (computed here, in the parent; the ranks import no JAX) and the
port's one-rank decode, reduced internlm2-20b in float32, logits within
1e-4 absolute (the reference's own bound, tests/test_multidevice.py);
the mesh loader, the input specs and the refusals.  Each world starts in about 3 s.  Expert parallelism:
tests/test_torch_mesh_ep.py; data parallelism and ZeRO-1:
tests/test_torch_mesh_train.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _mesh_ranks as ranks
from _mesh_parity import LOGIT_TOL, configs, jax_params
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.data import ShardedLoader, SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, spawn_world
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve.step import zeros_cache


def by_coord(results, key):
    return {tuple(r["coord"].values()): r[key] for r in results}


def test_seq_sharded_decode_matches_unsharded(tmp_path):
    """internlm2-20b reduced on (data 2, model 2): prefill 16, then 4
    decode steps, each rank holding 2 of 4 rows and 16 of 32 cache slots."""
    tcfg, jcfg = configs("internlm2-20b")
    jp, np_params = jax_params(jcfg)
    japi = jax_get_model(jcfg)
    b, s, max_seq = 4, 16, 32
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    steps = [rng.integers(0, tcfg.vocab, (b, 1)).astype(np.int32) for _ in range(4)]

    jcache = jparams.materialize(japi.cache_spec(jcfg, b, max_seq, 1), jax.random.PRNGKey(2),
                                 jnp.float32)
    jprefill = jax.jit(lambda p, t, c: japi.prefill(p, {"tokens": t}, jcfg, c))
    jdecode = jax.jit(lambda p, t, pos, c: japi.decode(p, t, pos, jcfg, c))
    lg, jcache = jprefill(jp, jnp.asarray(tokens), jcache)
    want = [np.asarray(lg)]
    for i, tok in enumerate(steps):
        lg, jcache = jdecode(jp, jnp.asarray(tok), jnp.int32(s + i), jcache)
        want.append(np.asarray(lg))

    api = get_model(tcfg)
    params = tparams.load_jax_params(np_params, tcfg, "cpu")
    cache = zeros_cache(tcfg, api, b, max_seq, device="cpu")
    lg, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, tcfg, cache)
    one = [lg]
    for i, tok in enumerate(steps):
        lg, cache = api.decode(params, torch.from_numpy(tok), s + i, tcfg, cache)
        one.append(lg)

    res = spawn_world(ranks.seq_decode, 4, "cpu", tmp_path / "store",
                      (tcfg, np_params, tokens, steps, max_seq))
    logits = by_coord(res, "logits")
    for d in (0, 1):
        for a, c in zip(logits[(d, 0)], logits[(d, 1)]):
            assert torch.equal(a, c)  # the model ranks agree bit for bit
    for i in range(len(steps) + 1):
        got = torch.cat([logits[(0, 0)][i], logits[(1, 0)][i]])
        assert float(np.max(np.abs(got.numpy() - want[i]))) < LOGIT_TOL, i
        assert float((got - one[i]).abs().max()) < LOGIT_TOL, i
    for r in res:
        assert r["cache_len"] == max_seq // 2
        # Three all_reduces a layer a decode step (max of m, sums of l, acc).
        assert r["stats"]["all_reduce"][0] == 3 * tcfg.n_layers * len(steps)


def test_seq_sharded_decode_refuses_multi_row():
    """The mesh decode is single-row, as the reference asserts."""
    from repro_torch.models import attention as A

    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("internlm2-20b")),
                              seq_shard_cache=True)
    q = torch.zeros(2, 3, cfg.n_heads, cfg.hd)
    with pytest.raises(ValueError, match="single-row"):
        A.flash_decode_attention(q, {}, 0, cfg, mesh=object())


class _StandIn:
    """A mesh at a coordinate, for what ``ShardedLoader`` reads."""

    def __init__(self, shape, axes, coord):
        self.axis_names, self.shape = tuple(axes), dict(zip(axes, shape))
        self.coord, self.device = dict(zip(axes, coord)), torch.device("cpu")

    def size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    index = Mesh.index


def test_sharded_loader_gives_each_rank_its_rows():
    cfg = tconfigs.reduced(tconfigs.get_config("whisper-tiny"))
    want = next(SyntheticTokens(cfg, 8, 8, seed=4))
    entries = {"tokens": ("batch", None), "frames": ("batch", None, None)}
    for shape, axes in (((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        for coord in np.ndindex(*shape):
            mesh = _StandIn(shape, axes, coord)
            loader = ShardedLoader(SyntheticTokens(cfg, 8, 8, seed=4), mesh, entries)
            try:
                got = next(loader)
            finally:
                loader.close()
            n = 8 // mesh.size([a for a in axes if a != "model"])
            i = mesh.index([a for a in axes if a != "model"])
            for k in ("tokens", "frames"):
                assert np.array_equal(got[k].numpy(), want[k][i * n:(i + 1) * n]), (coord, k)
    loader = ShardedLoader(SyntheticTokens(cfg, 8, 8, seed=4), None, entries, "cpu")
    try:
        assert np.array_equal(next(loader)["tokens"].numpy(), want["tokens"])
    finally:
        loader.close()


def test_input_specs_are_abstract():
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.specs import effective_seq, input_specs

    cfg = tconfigs.reduced(tconfigs.get_config("whisper-tiny"))
    cell = ShapeCell("train", 64, 8, "train")
    abstract, entries = input_specs(cfg, cell)
    assert abstract["tokens"].device.type == "meta"
    assert tuple(abstract["tokens"].shape) == (8, effective_seq(cfg, cell)) == (8, 32)
    assert entries == {"tokens": ("batch", None), "frames": ("batch", None, None)}
    _, dec = input_specs(cfg, ShapeCell("d", 64, 8, "decode"))
    assert dec == {"token": ("batch", None), "pos": ()}


def test_launcher_pod_mesh_needs_256_ranks():
    with pytest.raises(ValueError, match="256"):
        launch_train.main(["--arch", "qwen1.5-4b", "--device", "cpu", "--mesh", "pod",
                           "--steps", "1"])
    with pytest.raises(ValueError, match="512"):
        launch_train.main(["--arch", "qwen1.5-4b", "--device", "cpu", "--mesh", "multipod",
                           "--steps", "1"])


def test_world_refuses_a_mesh_of_another_size(tmp_path):
    msg = spawn_world(ranks.world_errors, 2, "cpu", tmp_path / "store")
    assert all("needs 4 ranks" in m and "world has 2" in m for m in msg)


def test_mesh_on_cuda_raises_without_a_card(monkeypatch):
    """A rank asked to compute on cuda raises without a card, as every
    entry point does (checked before any world is joined)."""
    from repro_torch.launch.mesh import rank_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rank_device("cuda", 2, 0)


def test_chip_smoke_mesh_phase_refuses_without_cuda():
    """``chip_smoke.py --mesh`` (the [mesh] phase alone) exits non-zero
    without a card and prints no result."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--mesh"], env=env,
                       capture_output=True, text=True, timeout=120, cwd=root)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr and '"mesh"' not in r.stdout
