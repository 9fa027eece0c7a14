"""The port's continuous-batching server on the recurrent families vs the
JAX package: reduced falcon-mamba-7b (ssm: conv and SSM state) and
recurrentgemma-2b (hybrid: conv and RG-LRU state, and a local-attention
ring of its window, 8 positions reduced, which a prompt of 8 and 6 tokens
generated wraps), float32, weights drawn in JAX and loaded with
``load_jax_params``.

Every served stream is held bitwise against the port's own one-shot
``make_generate`` of its padded prompt at batch 1 (the server's contract:
a request padded to its bucket generates as one-shot generate on the
padded prompt, whatever batch it shares and however segments interleave)
and exactly against the JAX package's one-shot tokens on the same weights.
Recurrent caches have no per-position timeline, so they are served on the
contiguous layout only (paging, chunking and speculation are refused:
``tests/test_torch_chunked.py``, ``tests/test_torch_spec.py``)."""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _mesh_graph_ranks import CPUReplay
from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.core import DeviceGroup, Static
from repro_torch.launch import serve as launcher
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import ForceMigrate, InferenceServer, ModelKernels, make_generate

ARCHS = ["falcon-mamba-7b", "recurrentgemma-2b"]
PLEN = 8
GEN = 6


class Model:
    """One reduced recurrent arch: the port's (cfg, api, params) on the
    JAX weights, and its memoized batch-1 references."""

    def __init__(self, arch: str) -> None:
        jcfg = jconfigs.reduced(jconfigs.get_config(arch))
        japi = jax_get_model(jcfg)
        jp = jparams.materialize(japi.param_spec(jcfg, 1), jax.random.PRNGKey(0), jnp.float32)
        self.cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                                       kernel_impl="cuda")
        self.api = get_model(self.cfg)
        self.params = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                              self.cfg, "cpu")
        self._jgen = jserve.make_generate(jcfg, japi)
        self._jp = jp
        self._tgen = make_generate(self.cfg, self.api)
        self._memo: dict = {}

    def _ref(self, which: str, prompt, n: int) -> np.ndarray:
        key = (which, np.asarray(prompt).tobytes(), n)
        if key not in self._memo:
            p = np.asarray(prompt, np.int32)[None]
            if which == "jax":
                got = np.asarray(self._jgen(self._jp, {"tokens": jnp.asarray(p)}, n))[0]
            else:
                got = self._tgen(self.params, {"tokens": torch.from_numpy(p)}, n)[0].numpy()
            self._memo[key] = got
        return self._memo[key]

    def check(self, prompts, gens, results) -> None:
        """Each stream == the port's batch-1 one-shot of its padded prompt,
        bitwise, and == the JAX package's tokens."""
        for p, n, got in zip(prompts, gens, results):
            padded = np.zeros(PLEN, np.int32)
            padded[: len(p)] = p
            np.testing.assert_array_equal(got, self._ref("port", padded, n))
            np.testing.assert_array_equal(got, self._ref("jax", padded, n))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return Model(request.param)


def prompts_for(cfg, seed: int, n: int, lens=None):
    rng = np.random.default_rng(seed)
    lens = lens or [PLEN] * n
    return [rng.integers(1, cfg.vocab, k).astype(np.int32) for k in lens]


def serve(model, prompts, gens, *, groups=None, gap=0.0, **kw):
    """``prompts`` through an InferenceServer on the CPU (one group unless
    ``groups``), submitted ``gap`` seconds apart; (results, stats)."""
    kw.setdefault("max_batch", 3)
    kw.setdefault("seg_len", 2)
    with InferenceServer(model.cfg, model.api, model.params,
                         groups=groups or [DeviceGroup("rs", device="cpu")],
                         scheduler=Static(), buckets=(PLEN,), max_new_cap=GEN,
                         max_wait_ms=5.0, **kw) as srv:
        handles = []
        for p, n in zip(prompts, gens):
            time.sleep(gap)
            handles.append(srv.submit(p, n))
        results = [h.result(timeout=300) for h in handles]
        stats = srv.stats()
    return results, stats


# ----------------------------------------------------------- one group
def test_joins_and_exits_between_segments(model):
    """Seven requests over three slots, arriving apart and asking for 3 or
    6 tokens: requests exit at segment boundaries and later ones join
    the live batch into the freed rows (their conv, SSM or RG-LRU state
    and ring rewritten by the wave's prefill); every stream bitwise its
    batch-1 one-shot and equal to the JAX package's."""
    prompts = prompts_for(model.cfg, 11, 7)
    gens = [GEN, 3, GEN, 3, GEN, GEN, 3]
    results, s = serve(model, prompts, gens, gap=0.004)
    model.check(prompts, gens, results)
    assert s["completed"] == 7 and s["failed"] == 0 and s["rejected"] == 0
    assert s["prefill_waves"] >= 3, s["prefill_waves"]  # 7 requests, 3 slots
    assert s["memory"]["mode"] == "contiguous"


def test_short_prompt_serves_as_its_padded_prompt(model):
    """Prompts of 3, 5 and 8 tokens share one bucket of 8: each is
    right-padded with the server's pad id and generates exactly as one-shot
    generate of the padded prompt (the reference's serving contract), in
    the port and in the JAX package; the padding is not the prompt's own
    tail (one-shot of the unpadded prompt of 5 differs)."""
    prompts = prompts_for(model.cfg, 21, 3, lens=[3, 5, PLEN])
    results, s = serve(model, prompts, [GEN] * 3)
    model.check(prompts, [GEN] * 3, results)
    assert s["completed"] == 3
    alone = model._tgen(model.params, {"tokens": torch.from_numpy(prompts[1][None])},
                        GEN)[0].numpy()
    assert not np.array_equal(alone, results[1])


def test_graphed_loops_replay_recurrent_state(model):
    """The segment loops and prefill waves through ``CPUReplay`` (the CUDA
    graphs' emulation: a replay reruns the loop on its static buffers, the
    recurrent state and the ring written in place there and copied back
    to the slot rows) serve the eager server's streams bitwise; one loop
    captured, before any cache was live; every segment one replay and
    every wave one replay of the group's graph."""
    prompts = prompts_for(model.cfg, 31, 5)
    gens = [GEN, 3, GEN, GEN, 3]
    eager, _ = serve(model, prompts, gens, gap=0.003)
    kernels = ModelKernels(model.cfg, model.api, model.params, graph=True)
    kernels.graphs = CPUReplay()
    group = DeviceGroup("rs", device="cpu")
    group.graphs = CPUReplay()
    got, s = serve(model, prompts, gens, groups=[group], gap=0.003, kernels=kernels)
    for e, r in zip(eager, got):
        np.testing.assert_array_equal(r, e)
    model.check(prompts, gens, got)
    g = s["graphs"]
    assert g["replays"] == s["segments"] > 0
    assert g["captures"] == 1 and g["warmup_clone_bytes"] == 0
    w = s["group_graphs"]["rs"]
    assert w["replays"] == s["prefill_waves"] and w["warmup_clone_bytes"] == 0


# ---------------------------------------------------------- two groups
def test_forced_migration_patches_recurrent_rows(model):
    """Two CPU groups, one sub-batch each, a migration forced at every
    common segment boundary: slots hop between the groups mid-decode,
    their conv, SSM or RG-LRU rows and ring rows patched into the other
    group's device copy (``DeviceGroup.patch_cached``); every stream
    bitwise its batch-1 one-shot and equal to the JAX package's."""
    policy = ForceMigrate()
    groups = [DeviceGroup(n, device="cpu") for n in ("rsa", "rsb")]
    prompts = prompts_for(model.cfg, 41, 6)
    gens = [GEN, 5, GEN, GEN, 5, GEN]
    results, s = serve(model, prompts, gens, groups=groups, group_batches=True,
                       migration=policy, max_batch=4)
    model.check(prompts, gens, results)
    assert s["completed"] == 6 and s["slot_migrations"] >= 1 and policy.moves_planned >= 1
    per = s["placement"]["per_group"]
    assert sum(d["migrations_in"] for d in per.values()) == s["slot_migrations"]
    assert sum(p["patched"] for p in s["placement"]["patches"].values()) >= 1


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("groups", [[], ["--groups", "2", "--scheduler", "hguided",
                                         "--drain-after", "4"]], ids=["one", "two"])
def test_launcher_server_verify(model, groups, capsys, monkeypatch):
    """``--server --device cpu --verify`` on the JAX weights (the
    launcher's ``load_model`` handing them over): 8 requests, streams
    bitwise batch-1 one-shot generate (the launcher's ``--verify``) and
    equal to the JAX package's; with ``--groups 2 --drain-after 4``, pod-b
    drained (whether a row of it is still live to migrate then follows the
    host's timing: ``test_forced_migration_patches_recurrent_rows`` forces
    migrations)."""
    monkeypatch.setattr(launcher, "load_model", lambda args: (model.cfg, model.api,
                                                              model.params))
    result = launcher.main(["--arch", model.cfg.name.removesuffix("-smoke"), "--server",
                            "--device", "cpu", "--verify", "--requests", "8", "--prompt-len",
                            str(PLEN), "--gen", str(GEN), "--max-batch", "4",
                            "--seed", "3"] + groups)
    out = capsys.readouterr().out
    assert "verify: 8 results bit-identical to one-shot generate" in out
    model.check(result["prompts"], [GEN] * 8, result["results"])
    if groups:
        assert "drained=pod-b" in out and result["drained"] == "pod-b"
        assert result["stats"]["placement"]["draining"] == ["pod-b"]


def test_server_without_a_card_raises(model, monkeypatch):
    """``--server`` without ``--device cpu`` on a host with no card raises:
    a served recurrent run is on the card or refused, never moved to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.main(["--arch", model.cfg.name.removesuffix("-smoke"), "--server",
                       "--requests", "1", "--prompt-len", str(PLEN), "--gen", "2"])


def test_chip_smoke_recurrent_served_phase_refuses_without_cuda():
    """``chip_smoke.py --recurrent-served`` (the [recurrent served] phase
    alone) exits non-zero without a card and prints no result."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--recurrent-served"],
                       env=env, capture_output=True, text=True, timeout=120, cwd=root)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr and '"recurrent_served"' not in r.stdout
