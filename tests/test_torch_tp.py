"""Tensor parallelism over "model" of the dense and vlm families on gloo
worlds of CPU ranks (``spawn_world``), reduced configs in float32 with
the JAX package's weights: qwen1.5-4b (QKV bias, the heads scheme),
internlm2-20b (GQA, reduced to one kv head: qheads) and paligemma-3b
(vlm, the prefix-LM prefill, a tied head: qheads) on (model 2); one-shot
generate under the mesh; the greedy argmax over a sliced vocabulary.  The
world runs every case in turn (one world start).  The moe family:
tests/test_torch_tp_moe.py; (data 2, model 2): tests/test_torch_tp_data.py; the hd scheme and the seq-sharded
decode: tests/test_torch_tp_schemes.py; slices straddling a GQA group or
an RG-LRU block: tests/test_torch_tp_straddle.py; checkpoints and ZeRO-1:
tests/test_torch_tp_state.py; ssm, hybrid and audio:
tests/test_torch_tp_recurrent.py.

Tolerances (``_tp_parity``): prefill logits and three teacher-forced
decode steps 1e-4 against the JAX package's single-device functions (the
mesh tests' bound), with the same greedy tokens, and 1e-5 of the logits'
largest magnitude against the port's one-rank run (the one-rank port
itself parts from JAX by up to 5e-5 on these configs); the train step's
loss 1e-5 against the JAX loss and its gradients 1e-4 relative L2 a leaf
against the port's one-rank gradients; across the model ranks of a row,
the logits, the greedy tokens and the head's replicated input bitwise
equal, and every parameter after AdamW bitwise equal on every rank."""
import numpy as np
import pytest
import torch

from _tp_parity import Suite, check_generate


def ties():
    """Rows over the 256-token vocabulary whose greatest logit ties across
    the two ranks' slices, within one slice, or everywhere."""
    t = np.random.default_rng(9).normal(size=(4, 256)).astype(np.float32)
    t[0, [10, 200]] = 9.0
    t[1, [130, 131]] = 9.0
    t[2, 250] = 9.0
    t[3] = 1.0
    return t


SUITE = Suite({"dense-bias": ("qwen1.5-4b", {"generate": 6}),
               "dense-gqa": ("internlm2-20b", {}),
               "vlm": ("paligemma-3b", {})},
              {"model2": ((2,), ("model",), ["dense-bias", "dense-gqa", "vlm"])}, ties())


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_tensor_parallel_matches_reference(mesh, name):
    SUITE.check(mesh, name)


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_sliced_leaves_hold_the_reference_shard_shapes(mesh, name):
    SUITE.check_shapes(mesh, name)


def test_one_shot_generate_under_the_mesh():
    check_generate(SUITE, "model2", "dense-bias")


def test_greedy_argmax_over_sliced_vocabulary():
    want = torch.from_numpy(ties()).argmax(dim=-1)
    assert want.tolist() == [10, 130, 250, 0]
    for r in SUITE.world("model2").values():
        assert torch.equal(r["ties"], want), r["coord"]
