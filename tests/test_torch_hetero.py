"""The port's heterogeneous trainer and gradient compression: the
counterparts of tests/test_hetero.py's seven tests on CPU groups, one
step held against the JAX package's HeteroTrainer, and the two training
examples on ``--device cpu``."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # property tests skip, unit tests still run
    from _hypothesis_stub import given, settings, st

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import train as jtrain
from repro.core.device import DeviceGroup as JaxDeviceGroup
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro.train.hetero import HeteroTrainer as JaxHeteroTrainer
from repro_torch import configs as tconfigs
from repro_torch.core.device import DeviceGroup
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.train import make_train_step, state_spec
from repro_torch.train.compression import ErrorFeedback, compress_tree, decompress_tree
from repro_torch.train.hetero import HeteroTrainer

ROOT = Path(__file__).resolve().parents[1]
# Same schedule the loss-decrease test uses: the default warmup (100 steps)
# keeps lr ~1e-5 over a 16-step test, far too small to observe learning.
LR = {"peak": 1e-3, "warmup": 5, "decay_steps": 10_000}


def build():
    cfg = tconfigs.reduced(tconfigs.get_config("granite-34b"))
    api = get_model(cfg)
    state = tparams.materialize(state_spec(cfg, api.param_spec(cfg)),
                                torch.Generator().manual_seed(0), torch.float32, "cpu")
    return cfg, api, state


def batch_of(cfg, b=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def cpu(name, **kw):
    return DeviceGroup(name, "cpu", **kw)


def test_hetero_single_group_matches_spmd_step():
    cfg, api, state = build()
    state2 = tparams.tree_map(torch.clone, state)
    batch = batch_of(cfg)
    trainer = HeteroTrainer(cfg, api, [cpu("solo")])
    s_h, m_h = trainer.step(state, batch)
    s_s, m_s = make_train_step(cfg, api)(state2, to_device(batch, "cpu"))
    trainer.shutdown()
    assert abs(m_h["loss"] - float(m_s["loss"])) < 1e-5
    d = max(float((a - b).abs().max()) for a, b in
            zip(tparams.tree_leaves(s_h["params"]), tparams.tree_leaves(s_s["params"])))
    assert d < 1e-5


def test_hetero_multi_group_loss_decreases():
    cfg, api, state = build()
    groups = [cpu("fast", power=2.0), cpu("slow", power=1.0, sim_time_per_wi=2e-3)]
    trainer = HeteroTrainer(cfg, api, groups, lr_kwargs=LR)
    losses = []
    # Learnable (Zipf-skewed) tokens: uniform-random data sits at the
    # entropy floor and cannot show a decrease.
    for _, batch in zip(range(16), SyntheticTokens(cfg, 8, 16, seed=3)):
        state, m = trainer.step(state, batch)
        losses.append(m["loss"])
    trainer.shutdown()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_straggler_share_shrinks():
    """A group that slows down must receive a smaller share next steps."""
    cfg, api, state = build()
    fast = cpu("fast", power=1.0, sim_time_per_wi=1e-4)
    slow = cpu("slow", power=1.0, sim_time_per_wi=8e-3)  # 80x straggler
    trainer = HeteroTrainer(cfg, api, [fast, slow])
    shares = []
    for i in range(6):
        state, m = trainer.step(state, batch_of(cfg, b=16, seed=i))
        shares.append(m["shares"])
    trainer.shutdown()
    assert shares[-1][0] > shares[0][0], f"fast share should grow: {shares}"
    assert shares[-1][1] < shares[0][1], f"slow share should shrink: {shares}"


def test_partition_covers_batch_exactly():
    cfg, api, _ = build()
    trainer = HeteroTrainer(cfg, api, [cpu(f"g{i}", power=p)
                                       for i, p in enumerate([1.0, 2.5, 4.0])])
    for b in (3, 8, 17, 64):
        shares = trainer.partition(b)
        assert sum(shares) == b
        assert all(s >= 1 for s in shares)
    trainer.shutdown()


@given(st.lists(st.floats(-100, 100, width=32), min_size=1, max_size=64))
@settings(max_examples=50, deadline=None)
def test_quantize_bounded_error(vals):
    g = {"w": torch.tensor(np.array(vals, np.float32))}
    deq = decompress_tree(compress_tree(g))
    scale = max(abs(np.array(vals)).max(), 1e-12) / 127.0
    err = np.abs(deq["w"].numpy() - np.array(vals, np.float32)).max()
    assert err <= scale * 0.5 + 1e-6


def test_error_feedback_converges_in_mean():
    """Sum of compressed grads over steps tracks sum of true grads."""
    ef = ErrorFeedback()
    rng = np.random.default_rng(0)
    true_sum = np.zeros(32, np.float32)
    comp_sum = np.zeros(32, np.float32)
    for _ in range(200):
        g = {"w": torch.from_numpy(rng.normal(size=32).astype(np.float32) * 0.01)}
        true_sum += g["w"].numpy()
        comp_sum += decompress_tree(ef.compress(g))["w"].numpy()
    # Residual is bounded by one quantization step, not accumulated drift.
    assert np.abs(true_sum - comp_sum).max() < 0.01


def test_compressed_training_still_learns():
    cfg, api, state = build()
    trainer = HeteroTrainer(cfg, api, [cpu("a"), cpu("b")], compress=True, lr_kwargs=LR)
    losses = []
    for _, batch in zip(range(16), SyntheticTokens(cfg, 8, 16, seed=3)):
        state, m = trainer.step(state, batch)
        losses.append(m["loss"])
    trainer.shutdown()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_quantize_matches_jax():
    from repro.train import compression as jcomp

    g = np.random.default_rng(3).normal(size=(6, 5)).astype(np.float32) * 4
    q, scale = compress_tree({"w": torch.from_numpy(g)})["w"]
    jq, jscale = jcomp.quantize(jnp.asarray(g))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


def test_hetero_step_matches_jax_hetero_step():
    """Two equal groups (a 4/4 split) from the same state and batch: the
    port's combined step equals the JAX HeteroTrainer's within the train
    step's tolerances (tests/test_torch_train.py)."""
    jcfg = jconfigs.reduced(jconfigs.get_config("granite-34b"))
    japi = jax_get_model(jcfg)
    jst = jparams.materialize(jtrain.state_spec(jcfg, japi.param_spec(jcfg, 1)),
                              jax.random.PRNGKey(0), jnp.float32)
    tcfg = tconfigs.reduced(tconfigs.get_config("granite-34b"))
    npst = jax.tree_util.tree_map(np.asarray, jst)
    st = {"params": tparams.load_jax_params(npst["params"], tcfg, "cpu"),
          "opt": {k: tparams.tree_map(lambda a: torch.from_numpy(np.array(a)), npst["opt"][k])
                  for k in ("m", "v")},
          "step": torch.tensor(0, dtype=torch.int32)}
    batch = batch_of(tcfg)
    jtr = JaxHeteroTrainer(jcfg, japi, [JaxDeviceGroup("a"), JaxDeviceGroup("b")])
    jnew, jm = jtr.step(jst, batch)
    jtr.shutdown()
    trainer = HeteroTrainer(tcfg, get_model(tcfg), [cpu("a"), cpu("b")])
    new, m = trainer.step(st, batch)
    trainer.shutdown()
    assert m["shares"] == jm["shares"] == [4, 4]
    assert abs(m["loss"] - float(jm["loss"])) <= 1e-5
    for got, want in zip(tparams.tree_leaves(new["params"]),
                         jax.tree_util.tree_leaves(jnew["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("script,args,expect", [
    ("train_lm_torch.py", ["--steps", "3", "--batch", "2", "--seq", "16"], "done in"),
    ("hetero_train_torch.py", ["--steps", "2", "--batch", "4", "--seq", "16", "--compress"],
     "step   1 loss="),
], ids=["train_lm", "hetero_train"])
def test_example_runs_on_cpu(script, args, expect, tmp_path):
    extra = ["--ckpt", str(tmp_path / "ck")] if script == "train_lm_torch.py" else []
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
                        *args, *extra], env={"PYTHONPATH": str(ROOT / "src"),
                                             "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert expect in r.stdout


def test_examples_need_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / "hetero_train_torch.py"),
                        "--steps", "1"], env={"PYTHONPATH": str(ROOT / "src"),
                                              "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


