"""Tensor parallelism beside data parallelism: gloo worlds of CPU ranks on
(data 2, model 2) and (data 2), each data rank holding half the batch's
rows and each model rank its slices, reduced qwen1.5-4b (the heads
scheme, QKV bias) and reduced arctic-480b (the moe family's router and
experts sliced) in float32, with the tolerances of
tests/test_torch_tp.py; and one-shot generate of each data rank's rows
under the mesh.  arctic runs at capacity factor 100, where nothing drops,
and at the reference's 1.25 on batches of one repeated token (but one
position a row), where the first layer routes most tokens to the same two
experts and capacity binds: the reference's GSPMD step sizes C by the global batch and places
assignments in its flat order, which the port's data ranks reproduce
from their gathered routing; the prefill's drops, summed over the batch
ranks, equal the reference's, which drops at least one.  On (data 2) the
same case at 3 rows, which the data axis does not divide: every rank holds
the whole batch, as the reference's sharding leaves it, and dispatches it
as one rank does."""
import pytest

from _tp_parity import Suite, check_generate

SUITE = Suite({"dense-bias": ("qwen1.5-4b", {"generate": 6}),
               "moe-nodrop": ("arctic-480b", {"capacity_factor": 100.0}),
               "moe-drops": ("arctic-480b", {"same_token": True}),
               "moe-drops-whole": ("arctic-480b", {"same_token": True, "rows": 3})},
              {"data2-model2": ((2, 2), ("data", "model"),
                                ["dense-bias", "moe-nodrop", "moe-drops"]),
               "data2": ((2,), ("data",), ["moe-drops", "moe-drops-whole"])})


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_tensor_parallel_matches_reference(mesh, name):
    SUITE.check(mesh, name)


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_sliced_leaves_hold_the_reference_shard_shapes(mesh, name):
    SUITE.check_shapes(mesh, name)


def test_one_shot_generate_under_the_mesh():
    check_generate(SUITE, "data2-model2", "dense-bias")
