"""The hd scheme and the seq-sharded decode under tensor parallelism, on
a gloo world of 2 CPU ranks, reduced qwen1.5-4b in float32 (tolerances
as tests/test_torch_tp.py's):
- hd: 3 heads over (model 2) do not divide, their head dim 16 does: the
  partial scores summed over "model", RoPE on the gathered head;
- the seq-sharded decode composed with sliced heads (the heads scheme)
  and with a sliced head dim, its cache timeline split over the ranks.
Slices straddling a GQA group or an RG-LRU block:
tests/test_torch_tp_straddle.py; checkpoints and ZeRO-1:
tests/test_torch_tp_state.py."""
import pytest

from _tp_parity import Suite
from repro_torch.models import attention as A

SUITE = Suite({"hd": ("qwen1.5-4b", {"n_heads": 3, "n_kv_heads": 3}),
               "seq-heads": ("qwen1.5-4b", {"seq_shard_cache": True, "max_seq": 12}),
               "seq-hd": ("qwen1.5-4b", {"n_heads": 3, "n_kv_heads": 3,
                                         "seq_shard_cache": True, "max_seq": 12})},
              {"model2": ((2,), ("model",), ["hd", "seq-heads", "seq-hd"])})


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_scheme_matches_reference(mesh, name):
    SUITE.check(mesh, name)


@pytest.mark.parametrize("mesh,name", SUITE.pairs, ids=SUITE.ids)
def test_scheme_holds_the_reference_shard_shapes(mesh, name):
    SUITE.check_shapes(mesh, name)


def test_schemes_are_the_ones_meant():
    """The configs take the scheme their case names, and the seq-sharded
    caches hold half the timeline a rank."""
    cfg = {n: SUITE.case(n)[0]["cfg"] for n in SUITE.cases}
    assert A.scheme(cfg["hd"], 2) == A.scheme(cfg["seq-hd"], 2) == "hd"
    assert A.scheme(cfg["seq-heads"], 2) == "heads"
    for name in ("seq-heads", "seq-hd"):
        for r in SUITE.world("model2").values():
            shapes = r["cases"][name]["cache_shapes"]
            assert all(s[2] == 6 for s in shapes), (name, shapes)  # 12 slots over 2 ranks
