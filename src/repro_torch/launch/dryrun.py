"""Dry-run of every (arch, shape, mesh) cell on ``meta`` tensors: no
world, no card, nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
        --shape decode_32k --mesh pod --out build/dryrun

For each arch of the registry, each cell of ``configs.SHAPES`` and the
production meshes (16, 16) ("data", "model") and (2, 16, 16) ("pod",
"data", "model") (``launch.mesh.abstract_production_mesh``), it writes one
JSON, ``<out>/<arch>__<shape>__<mesh>.json``, under the JAX package's file
name and keys where they mean the same (``arch``, ``shape``, ``mesh``,
``status``, ``reason``, ``n_chips``, ``seq``, ``n_params``,
``model_flops_global``):

- ``cell_applicable``'s skip and its reason;
- the whole parameter count and the analytic model FLOPs (6 N D to train,
  2 N_active D to serve);
- one rank's local shapes and bytes, from the port's placements
  (``distributed.sharding.rank_placements``), of the parameters, the
  train state (ZeRO-1's m and v where the config sets it), the cache and
  the step's inputs (``launch.specs.input_specs``), each leaf built as a
  ``meta`` tensor;
- the leaves the port holds whole where the reference slices them over
  "model" (RG-LRU's ``gate_a``), with the bytes that costs a rank, and
  those it slices in a layout of its own (mamba's ``in_proj``, its x and
  z columns in ``distributed.sharding.Parts`` blocks), at the reference's
  bytes.

The JAX package's dry-run lowers and compiles each cell on 512 host
devices and reads XLA's cost and memory analysis, the HLO's collective
bytes and a roofline on the TPU v5e's constants.  None of those has an
analog on one GPU, so they are left out, and each JSON says so under
``"omitted"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path

from repro_torch.configs import SHAPES, all_archs, cell_applicable, get_config
from repro_torch.distributed.sharding import (entry_tree_shardings, local_shape, model_paths,
                                               named_sharding, rank_placements)
from repro_torch.launch.mesh import abstract_production_mesh, data_par, model_par
from repro_torch.launch.specs import effective_seq, input_specs
from repro_torch.models import get_model
from repro_torch.models.params import abstract, n_bytes, n_params, rank_counts, tree_map_path
from repro_torch.train.step import state_spec

OMITTED = ("XLA's cost analysis (flops and bytes a chip), its memory analysis and the HLO "
           "collective bytes of the reference's compiled cells, and its TPU v5e roofline "
           "constants: no analog on one GPU")


def model_flops(cfg, shape, seq: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N_active·D (inference), the
    reference's rule of thumb: N the whole parameter count, N_active with
    the routed experts scaled by top_k / E."""
    total = n_params(get_model(cfg).param_spec(cfg, 1))
    n_active = total
    if cfg.n_experts and cfg.top_k:
        expert = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * cfg.n_layers
        n_active = total - expert + expert * cfg.top_k / cfg.n_experts
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * seq
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * seq
    return 2.0 * n_active * shape.global_batch  # decode: one token a sequence


def _leaves(local_tree, dtype) -> dict:
    """Each leaf's local shape and bytes, by key path."""
    out = {}
    tree_map_path(lambda p, t: out.__setitem__(
        p, {"shape": list(t.shape), "bytes": t.numel() * t.element_size()}),
        abstract(local_tree, dtype))
    return out


def _count(local_tree, dtype) -> dict:
    n, b = rank_counts(local_tree, dtype)
    return {"elements": n, "bytes": b}


def held_whole(cfg, pspec, mesh, dtype) -> dict:
    """The leaves with a "model" entry that a rank holds whole: each one's
    whole bytes and the bytes it would hold at the reference's sharding."""
    named = set(get_model(cfg).model_sliced(cfg, mesh)["params"])
    specs = {}
    tree_map_path(lambda p, s: specs.__setitem__(p, s), pspec)
    out = {}
    for path in model_paths(pspec):
        if path in named:
            continue
        s = specs[path]
        ref = local_shape(s.shape, named_sharding(mesh, tuple(s.pspec), s.shape), mesh)
        whole = n_bytes(abstract(s, dtype))
        sliced = n_bytes(abstract(dataclasses.replace(s, shape=ref), dtype))
        out[path] = {"whole_bytes": whole, "reference_bytes": sliced,
                     "extra_bytes": whole - sliced}
    return out


def dry_cell(cfg, shape, mesh) -> dict:
    """The per-rank record of one applicable cell on ``mesh``."""
    api = get_model(cfg)
    par, dpar = model_par(mesh), data_par(mesh)
    pspec = api.param_spec(cfg, par)
    seq = effective_seq(cfg, shape)
    sliced = api.model_sliced(cfg, mesh)
    pdtype = cfg.param_dtype if shape.kind == "train" else cfg.compute_dtype
    plocal = rank_placements(cfg, pspec, mesh, "params")[1]
    rank = {"params": _count(plocal, pdtype), "param_leaves": _leaves(plocal, pdtype)}
    if shape.kind == "train":
        sspec = state_spec(cfg, pspec, dpar)
        rank["state"] = _count(rank_placements(cfg, sspec, mesh, "state")[1], cfg.param_dtype)
    else:
        cspec = api.cache_spec(cfg, shape.global_batch, seq, par)
        cache_dtype = cfg.cache_dtype or cfg.compute_dtype
        rank["cache"] = _count(rank_placements(cfg, cspec, mesh, "cache")[1], cache_dtype)
    inputs, entries = input_specs(cfg, shape)
    shard = entry_tree_shardings(entries, mesh, inputs)
    rank["inputs"] = {}
    for k, v in inputs.items():
        loc = local_shape(v.shape, shard[k], mesh)
        rank["inputs"][k] = {"shape": list(loc), "bytes": v.element_size() * math.prod(loc)}
    return {"status": "ok", "n_chips": mesh.n_ranks, "seq": seq, "n_params": n_params(pspec),
            "model_flops_global": model_flops(cfg, shape, seq), "model_par": par,
            "data_par": dpar, "zero1": cfg.zero1, "per_rank": rank,
            "held_whole": held_whole(cfg, pspec, mesh, pdtype), "parts": sliced.get("parts", {})}


def mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir=None,
             verbose: bool = True) -> dict:
    """One cell's record, written to ``out_dir`` (when given)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag(multi_pod), "overrides": {},
           "omitted": OMITTED}
    ok, why = cell_applicable(cfg, shape)
    if ok:
        rec.update(dry_cell(cfg, shape, abstract_production_mesh(multi_pod=multi_pod)))
    else:
        rec.update(status="skipped", reason=why)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}__{rec['mesh']}.json").write_text(
            json.dumps(rec, indent=1))
    if verbose:
        if rec["status"] == "ok":
            r = rec["per_rank"]
            held = r.get("state", r.get("cache"))
            print(f"[ok] {arch} {shape_name} {rec['mesh']}: params {rec['n_params']:,}, a rank "
                  f"{r['params']['bytes'] / 2**30:.2f} GiB of parameters, "
                  f"{held['bytes'] / 2**30:.2f} GiB of {'state' if 'state' in r else 'cache'}, "
                  f"held whole {sorted(rec['held_whole']) or 'none'}", flush=True)
        else:
            print(f"[skip] {arch} {shape_name}: {rec['reason']}", flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    archs = all_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    results = [run_cell(a, s, mp, args.out) for a in archs for s in shapes for mp in meshes]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped-by-design", flush=True)
    return results


if __name__ == "__main__":
    main()
