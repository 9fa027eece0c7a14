"""Tensor parallelism over "model" of the moe family on gloo worlds of
CPU ranks: reduced arctic-480b (its dense residual MLP, the router
column-sliced and gathered before top-k, the experts sliced by expert
over the reference's whole capacity buffer) and reduced kimi-k2-1t-a32b
under ``ep_shard_map`` (expert parallelism as it was, its dense leaves
sliced) on (model 2); arctic on (data 2, model 2):
tests/test_torch_tp_data.py.  The tolerances are tests/test_torch_tp.py's.
kimi's case runs at capacity factor 100, where expert parallelism
computes the unsharded MoE's values."""
import pytest

from _tp_parity import Suite

SUITE = Suite({"moe": ("arctic-480b", {}),
               "moe-ep": ("kimi-k2-1t-a32b", {"ep_shard_map": True, "capacity_factor": 100.0})},
              {"model2": ((2,), ("model",), ["moe", "moe-ep"])})


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_tensor_parallel_matches_reference(mesh, name):
    SUITE.check(mesh, name)


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_sliced_leaves_hold_the_reference_shard_shapes(mesh, name):
    SUITE.check_shapes(mesh, name)
