"""Tensor-parallel slices that straddle a group, on gloo worlds of CPU
ranks, reduced configs in float32 (tolerances as tests/test_torch_tp.py's):
- qheads with a GQA group straddling two ranks: internlm2-20b with 6 q
  heads over 3 kv heads on (model 2), 3 q heads a rank reading kv heads
  [0, 0, 1] and [1, 2, 2] (one kv head repeated a q head);
- RG-LRU blocks straddling ranks: recurrentgemma-2b with 3 blocks of 16
  channels over (model 2), 24 channels a rank, the gates computed over
  the gathered conv output (and its MQA attention under the hd scheme: 3
  heads do not divide by 2, their head dim does).
One world of 2 runs both cases."""
import dataclasses

import pytest

from _tp_parity import Suite
from repro_torch.models import attention as A

SUITE = Suite({"qheads-straddle": ("internlm2-20b", {"n_heads": 6, "n_kv_heads": 3}),
               "rglru-straddle": ("recurrentgemma-2b", {"n_heads": 3, "lru_width": 48})},
              {"model2": ((2,), ("model",), ["qheads-straddle", "rglru-straddle"])})


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_straddle_matches_reference(mesh, name):
    SUITE.check(mesh, name)


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_straddle_holds_the_reference_shard_shapes(mesh, name):
    SUITE.check_shapes(mesh, name)


class _Rank:
    def __init__(self, r):
        self.axis_names, self.shape, self.coord = ("model",), {"model": 2}, {"model": r}


def test_slices_straddle_as_meant():
    """The straddling ranks read the kv heads of their own q heads, and the
    RG-LRU case's rank slices are not whole blocks."""
    cfg = {n: SUITE.case(n)[0]["cfg"] for n in SUITE.cases}
    c = cfg["qheads-straddle"]
    assert A.scheme(c, 2) == "qheads"
    assert [A.kv_heads(3, c, _Rank(r)) for r in (0, 1)] == [[0, 0, 1], [1, 2, 2]]
    rg = dataclasses.replace(c, n_heads=10, n_kv_heads=1)  # recurrentgemma's MQA
    assert [A.kv_heads(5, rg, _Rank(r)) for r in (0, 1)] == [(0, 1), (0, 1)]
    h = cfg["rglru-straddle"]
    assert A.scheme(h, 2) == "hd"
    assert (h.lru_width // 2) % (h.lru_width // h.n_heads) != 0  # blocks straddle ranks
