"""Elastic training on gloo worlds of CPU ranks: the counterpart of the
reference's ``test_elastic_restore_smaller_world``.  A world of 2 trains
through ``repro_torch.launch.train`` with a checkpoint, loses a rank, and
``ElasticRunner.on_failure`` rebuilds on the survivor alone: the restored
parameters equal the trained ones bitwise, the data cursor is kept, and
the next step's loss is finite.  Under ZeRO-1 the checkpoint gathers m
and v (sliced over the data ranks) to the writer one leaf at a time, and
the world of one restores them whole, bitwise."""
import dataclasses

import numpy as np
import torch

import _mesh_ranks as ranks
from repro_torch import configs as tconfigs
from repro_torch.ckpt import latest_step
from repro_torch.data import SyntheticTokens
from repro_torch.launch.mesh import spawn_world
from repro_torch.models.params import tree_leaves

ARGV = ["--arch", "qwen1.5-4b", "--device", "cpu", "--kernel", "reference", "--batch", "4",
        "--seq", "16", "--seed", "0", "--steps", "3", "--ckpt-interval", "3",
        "--mesh-shape", "2x1"]


def test_elastic_restore_smaller_world(tmp_path):
    res = spawn_world(ranks.elastic_launcher, 2, "cpu", tmp_path / "store",
                      (ARGV, str(tmp_path / "ckpt"), str(tmp_path / "store_survivors")))
    r = res[0]
    assert res[1] == {"lost": True}
    assert latest_step(tmp_path / "ckpt") == 3
    assert r["restored_world"] == {"data": 1, "model": 1}
    assert r["cursor"] == r["launcher_cursor"] == 3
    for a, b in zip(tree_leaves(r["trained"]), tree_leaves(r["restored"])):
        assert torch.equal(a, b)
    assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))
    assert np.isfinite(r["next_loss"])


def test_elastic_zero1_checkpoint_restores_whole(tmp_path):
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config("qwen1.5-4b")), zero1=True)
    ds = SyntheticTokens(cfg, 4, 16, seed=5)
    batches = [next(ds), next(ds)]
    res = spawn_world(ranks.elastic_zero1, 2, "cpu", tmp_path / "store",
                      (cfg, str(tmp_path / "ckpt"), str(tmp_path / "store_survivors"), batches))
    r = res[0]
    assert r["world"] == {"data": 1, "model": 1} and r["cursor"] == 2
    spec_m = tree_leaves(r["whole"]["opt"]["m"])[0]
    assert int(np.prod(r["m_local"])) * 2 == spec_m.numel()  # sliced over 2 data ranks
    for a, b in zip(tree_leaves(r["whole"]), tree_leaves(r["restored"])):
        assert a.shape == b.shape and torch.equal(a, b)
    assert int(r["restored"]["step"]) == 2
    # One leaf at a time: the writer has written every earlier leaf when
    # the next leaf's gather starts.
    assert r["written"] == list(range(len(tree_leaves(r["whole"]))))
