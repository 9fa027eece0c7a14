"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's definitions, with no world and no card: for every arch x
``SHAPES`` cell x {pod, multipod}, the skip and its reason equal the
reference's ``cell_applicable``, ``n_params`` the reference's count of its
``param_spec``, and one rank's bytes the reference's shard shapes --
every parameter leaf, the train state (ZeRO-1 included) or the cache,
and the inputs -- resolved by ``repro.distributed.sharding`` on JAX
``AbstractMesh``es (which allocate nothing), except the leaves the port
holds whole (RG-LRU's ``gate_a``), which hold the reference's shard
shape less its "model" axis; mamba's ``in_proj``, sliced in blocks of its
own, holds the reference's shard shape.  Every check is exact.
``repro.launch.dryrun`` is not imported: it sets XLA_FLAGS to 512 host
devices when imported."""
import json
import math

import numpy as np
import pytest

import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro import train as jtrain
from repro.distributed import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s, mp) for a in jconfigs.all_archs() for s in jconfigs.SHAPES for mp in (False, True)]


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * jnp.dtype(dtype).itemsize


def _shard(s, mesh, whole: bool):
    """The reference leaf ``s``'s shard shape on ``mesh``; ``whole``: with
    its "model" entries dropped (a leaf the port holds whole)."""
    entries = tuple(None if e == "model" else e for e in s.pspec) if whole else tuple(s.pspec)
    return tuple(jsharding.named_sharding(mesh, entries, tuple(s.shape)).shard_shape(
        tuple(s.shape)))


def _tree_bytes(tree, mesh, dtype, whole=()) -> int:
    return sum(_nbytes(_shard(s, mesh, any(p.endswith(w) for w in whole)), s.dtype or dtype)
               for p, s in _walk(tree))


def test_every_arch_and_cell_is_the_reference_s():
    assert tconfigs.all_archs() == jconfigs.all_archs()
    assert {k: tuple(v.__dict__.values()) for k, v in tconfigs.SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{'multipod' if m else 'pod'}" for a, s, m in CELLS])
def test_dry_cell_equals_reference(arch, shape, multi_pod):
    rec = dryrun.run_cell(arch, shape, multi_pod, verbose=False)
    jcfg, cell = jconfigs.get_config(arch), jconfigs.SHAPES[shape]
    ok, why = jconfigs.cell_applicable(jcfg, cell)
    assert rec["status"] == ("ok" if ok else "skipped")
    assert rec["mesh"] == ("pod2x16x16" if multi_pod else "pod16x16")
    if not ok:
        assert rec["reason"] == why
        return
    mshape, axes = MESHES[multi_pod]
    mesh = AbstractMesh(mshape, axes)
    japi = jax_get_model(jcfg)
    pspec = japi.param_spec(jcfg, 16)
    assert rec["n_params"] == jparams.n_params(pspec)
    assert rec["n_chips"] == int(np.prod(mshape))
    whole = tuple(rec["held_whole"])
    pdtype = jcfg.param_dtype if cell.kind == "train" else jcfg.compute_dtype
    leaves = rec["per_rank"]["param_leaves"]
    assert set(leaves) == {p for p, _ in _walk(pspec)}
    for p, s in _walk(pspec):
        want = _shard(s, mesh, p in whole)
        assert tuple(leaves[p]["shape"]) == want, (p, leaves[p], want)
        assert leaves[p]["bytes"] == _nbytes(want, s.dtype or pdtype), p
        if p in whole:
            assert rec["held_whole"][p]["extra_bytes"] == \
                _nbytes(want, pdtype) - _nbytes(_shard(s, mesh, False), pdtype) > 0
    for p in whole:  # only the leaves the family names, with their reason
        assert p.endswith("/mix/gate_a"), p
    assert set(rec["parts"]) <= {"layers/in_proj"}
    if cell.kind == "train":
        sspec = jtrain.state_spec(jcfg, pspec, int(np.prod(mshape)) // 16)
        want = _tree_bytes(sspec, mesh, jcfg.param_dtype, whole)
        assert rec["per_rank"]["state"]["bytes"] == want
    else:
        seq = jspecs.effective_seq(jcfg, cell)
        cspec = japi.cache_spec(jcfg, cell.global_batch, seq, 16)
        want = _tree_bytes(cspec, mesh, jcfg.cache_dtype or jcfg.compute_dtype)
        assert rec["per_rank"]["cache"]["bytes"] == want
    abstract, entries = jspecs.input_specs(jcfg, cell)
    for k, a in abstract.items():
        ns = jsharding.named_sharding(mesh, tuple(entries[k]), tuple(a.shape))
        assert tuple(rec["per_rank"]["inputs"][k]["shape"]) == tuple(ns.shard_shape(a.shape)), k


def test_cli_writes_one_json_a_cell(tmp_path):
    recs = dryrun.main(["--arch", "falcon-mamba-7b", "--out", str(tmp_path)])
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == len(recs) == 8
    rec = json.loads((tmp_path / "falcon-mamba-7b__train_4k__pod16x16.json").read_text())
    assert rec["status"] == "ok" and "XLA" in rec["omitted"]
    assert rec["held_whole"] == {} and rec["parts"] == {"layers/in_proj": 2}
    # float32 masters, m and v: 12 bytes a parameter, about 1/16 of them
    # a rank (the norms are whole)
    assert rec["n_params"] * 12 // 16 < rec["per_rank"]["state"]["bytes"] < \
        rec["n_params"] * 12 // 15
