"""Tensor parallelism over "model" of the ssm, hybrid and audio families
on a gloo world of 2 CPU ranks (model 2), reduced configs in float32
with the JAX package's weights (tolerances as tests/test_torch_tp.py's):
falcon-mamba-7b (di/par channels on ``ssm_scan``'s plain version, x_proj
and out_proj row-parallel, ``in_proj`` held whole and read as its two
column slices), recurrentgemma-2b (the RG-LRU width on ``rglru_scan``'s
plain version, its blocks' gates from the whole ``gate_a``, the MQA
attention under the qheads scheme, the tied head sliced over the
vocabulary) and whisper-tiny (the hd scheme in the encoder, the decoder
and cross-attention, with the cross keys sliced on hd; its MLP column-
then row-parallel; its tied head sliced over the reduced vocabulary).
The world runs the three cases in turn.  whisper's gradients are held at
1e-3 relative L2 a leaf, the one-rank parity suite's bound for it
(tests/_train_parity.py): on this case the one-rank port's own gradients
part from the JAX package's by up to 2.2e-4, where qwen's part by 1e-5,
and the ranks' partial sums, in another order, move them by 1.2e-4."""
import pytest

from _tp_parity import Suite

SUITE = Suite({"ssm": ("falcon-mamba-7b", {}), "hybrid": ("recurrentgemma-2b", {}),
               "audio": ("whisper-tiny", {"grad_rel": 1e-3})},
              {"model2": ((2,), ("model",), ["ssm", "hybrid", "audio"])})


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_tensor_parallel_matches_reference(mesh, name):
    SUITE.check(mesh, name)


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_sliced_leaves_hold_the_reference_shard_shapes(mesh, name):
    SUITE.check_shapes(mesh, name)
