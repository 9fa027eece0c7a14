"""Tensor parallelism beside data parallelism: a gloo world of 4 CPU
ranks on (data 2, model 2), each data rank holding half the batch's rows
and each model rank its slices, reduced qwen1.5-4b (the heads scheme,
QKV bias) and reduced arctic-480b (the moe family's router and experts
sliced) in float32, with the tolerances of tests/test_torch_tp.py; and
one-shot generate of each data rank's rows under the mesh.  arctic's case
runs at capacity factor 100: the port's MoE sizes its capacity and drops
by the data rank's tokens, where the reference's GSPMD step takes the
global batch's (ROADMAP.md C12), and at no-drop capacity both compute
the same values."""
import pytest

from _tp_parity import Suite, check_generate

SUITE = Suite({"dense-bias": ("qwen1.5-4b", {"generate": 6}),
               "moe-nodrop": ("arctic-480b", {"capacity_factor": 100.0})},
              {"data2-model2": ((2, 2), ("data", "model"), ["dense-bias", "moe-nodrop"])})


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_tensor_parallel_matches_reference(mesh, name):
    SUITE.check(mesh, name)


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_sliced_leaves_hold_the_reference_shard_shapes(mesh, name):
    SUITE.check_shapes(mesh, name)


def test_one_shot_generate_under_the_mesh():
    check_generate(SUITE, "data2-model2", "dense-bias")
