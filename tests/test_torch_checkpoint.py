"""The port's checkpoints: the counterparts of tests/test_checkpoint.py
(round trip, latest step and garbage collection, partial writes ignored,
shape mismatch refused, restart equal to the uninterrupted run bitwise on
the CPU, restore onto another placement), checkpoints crossing between the
two packages in both directions (the reference's layout), bfloat16 leaves,
and the launcher's ``--ckpt`` / ``--restore``."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import ckpt as jckpt
from repro_torch import configs as tconfigs
from repro_torch.ckpt import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.data import SyntheticTokens, to_device
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.train import make_train_step, state_spec

ROOT = Path(__file__).resolve().parents[1]


def small_state():
    return {
        "params": {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}},
        "opt": {"m": {"x": torch.zeros(2)}, "v": {"x": torch.zeros(2)}},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def leaves_equal(a, b):
    la, lb = tparams.tree_leaves(a), tparams.tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_roundtrip_identity(tmp_path):
    st = small_state()
    save_checkpoint(tmp_path, 7, st, {"cursor": 3})
    got, extra = restore_checkpoint(tmp_path, 7, tparams.tree_map(torch.zeros_like, st))
    assert extra == {"cursor": 3}
    assert leaves_equal(got, st)


def test_latest_step_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, interval=1, keep=2)
    st = small_state()
    for i in range(1, 6):
        mgr.maybe_save(i, st)
    mgr.finalize()
    assert latest_step(tmp_path) == 5
    assert sorted(p.name for p in Path(tmp_path).glob("step_*")) == ["step_4", "step_5"]


def test_restore_ignores_partial_writes(tmp_path):
    save_checkpoint(tmp_path, 1, small_state())
    bad = Path(tmp_path) / ".tmp_step_2"  # a crash mid-write: no manifest
    bad.mkdir()
    (bad / "garbage.npy").write_bytes(b"junk")
    assert latest_step(tmp_path) == 1


def test_shape_mismatch_rejected(tmp_path):
    st = small_state()
    save_checkpoint(tmp_path, 1, st)
    like = tparams.tree_map(torch.zeros_like, st)
    like["params"]["a"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, 1, like)


def test_restore_takes_the_like_states_placement(tmp_path):
    """The elastic path's counterpart: leaves land on the like state's
    dtype (and device), values unchanged."""
    st = small_state()
    save_checkpoint(tmp_path, 1, st)
    like = tparams.tree_map(lambda t: torch.zeros_like(t, dtype=torch.float64)
                            if t.is_floating_point() else t, st)
    got, _ = restore_checkpoint(tmp_path, 1, like)
    assert got["params"]["a"].dtype == torch.float64
    assert torch.equal(got["params"]["a"], st["params"]["a"].double())


def test_layout_is_the_references(tmp_path):
    """One step_<N>/ with MANIFEST.json and one .npy a leaf, named by its
    dict path with '/' as '__'; the manifest's keys, shapes, dtypes and
    tree string as the JAX package writes them for the same tree."""
    st = small_state()
    save_checkpoint(tmp_path / "port", 7, st, {"cursor": 3})
    jst = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), st)
    jckpt.save_checkpoint(tmp_path / "jax", 7, jst, {"cursor": 3})
    port, ref = tmp_path / "port" / "step_7", tmp_path / "jax" / "step_7"
    assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in ref.iterdir())
    assert json.loads((port / "MANIFEST.json").read_text()) == \
        json.loads((ref / "MANIFEST.json").read_text())


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    jst = {"params": {"w": jnp.asarray(rng.normal(size=(3, 5)).astype(np.float32)),
                      "h": jnp.asarray(rng.normal(size=(4,)), jnp.bfloat16)},
           "step": jnp.int32(12)}
    jckpt.save_checkpoint(tmp_path, 12, jst, {"data_cursor": 12})
    like = {"params": {"w": torch.zeros(3, 5), "h": torch.zeros(4, dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}
    got, extra = restore_checkpoint(tmp_path, latest_step(tmp_path), like)
    assert extra == {"data_cursor": 12} and int(got["step"]) == 12
    np.testing.assert_array_equal(got["params"]["w"].numpy(), np.asarray(jst["params"]["w"]))
    # bf16 through a 16-bit view on both sides: the same bits.
    assert np.array_equal(got["params"]["h"].view(torch.int16).numpy(),
                          np.asarray(jst["params"]["h"]).view(np.int16))


def test_port_checkpoint_restores_in_jax(tmp_path):
    st = small_state()
    st["params"]["a"] = torch.randn(2, 3, generator=torch.Generator().manual_seed(1))
    save_checkpoint(tmp_path, 7, st, {"cursor": 3})
    like = jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                                 jnp.dtype(str(t.dtype)[6:])),
                                  st)
    got, extra = jckpt.restore_checkpoint(tmp_path, 7, like)
    assert extra == {"cursor": 3}
    for a, b in zip(tparams.tree_leaves(st), jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bf16_leaf_roundtrip(tmp_path):
    st = {"w": torch.randn(7, 3, generator=torch.Generator().manual_seed(2)).bfloat16(),
          "s": torch.tensor(1, dtype=torch.int32)}
    save_checkpoint(tmp_path, 1, st)
    manifest = json.loads((tmp_path / "step_1" / "MANIFEST.json").read_text())
    assert manifest["dtypes"]["w"] == "bfloat16"
    assert np.load(tmp_path / "step_1" / "w.npy").dtype == np.dtype("V2")  # the JAX layout
    got, _ = restore_checkpoint(tmp_path, 1, tparams.tree_map(torch.zeros_like, st))
    assert leaves_equal(got, st)


def test_restart_equals_uninterrupted_run(tmp_path):
    """Kill/restart mid-training == never interrupted (bitwise on the CPU)."""
    cfg = tconfigs.reduced(tconfigs.get_config("qwen1.5-4b"))
    api = get_model(cfg)
    sspec = state_spec(cfg, api.param_spec(cfg))

    def run(n_steps, state, cursor):
        ds = SyntheticTokens(cfg, 4, 16, seed=11)
        ds.seek(cursor)
        step = make_train_step(cfg, api)
        for _, batch in zip(range(n_steps), ds):
            state, _ = step(state, to_device(batch, "cpu"))
        return state, ds.state()["cursor"]

    s0 = tparams.materialize(sspec, torch.Generator().manual_seed(4), torch.float32, "cpu")
    full, _ = run(6, tparams.tree_map(torch.clone, s0), 0)
    half, cur = run(3, tparams.tree_map(torch.clone, s0), 0)
    save_checkpoint(tmp_path, 3, half, {"cursor": cur})
    restored, extra = restore_checkpoint(tmp_path, 3, tparams.tree_map(torch.zeros_like, half))
    assert leaves_equal(restored, half)
    resumed, _ = run(3, restored, extra["cursor"])
    assert leaves_equal(full, resumed)


def test_launcher_restart_equals_uninterrupted_run(tmp_path):
    """launch/train.py with --ckpt: 6 steps straight, and 4 steps then
    --restore to 6, give the same losses and the same state, bitwise."""
    base = ["--arch", "qwen1.5-4b", "--device", "cpu", "--batch", "4", "--seq", "16",
            "--ckpt-interval", "2"]
    full = launch_train.main(base + ["--steps", "6", "--ckpt", str(tmp_path / "a")])
    first = launch_train.main(base + ["--steps", "4", "--ckpt", str(tmp_path / "b")])
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["step_2", "step_4"]
    rest = launch_train.main(base + ["--steps", "6", "--ckpt", str(tmp_path / "b"),
                                     "--restore"])
    assert (rest["start"], rest["cursor_at_start"], rest["data_cursor"]) == (4, 4, 6)
    assert first["losses"] + rest["losses"] == full["losses"]
    assert leaves_equal(full["state"], rest["state"])


def test_launcher_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "qwen1.5-4b", "--steps", "1"])


def test_launcher_runs_as_a_module(tmp_path):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "whisper-tiny", "--device", "cpu", "--steps", "2", "--batch", "2",
                        "--seq", "8"], env={"PYTHONPATH": str(ROOT / "src"),
                                            "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "step     1 loss=" in r.stdout and "done: 2 steps" in r.stdout
