"""Asynchronous, atomic checkpoints in the JAX package's layout.

Layout per step (``src/repro/ckpt/checkpoint.py``), readable by either
package:  <dir>/step_<N>/
    MANIFEST.json   -- step, keys, shapes, dtypes, the tree's structure and
                       ``extra`` (the data cursor)
    <leafpath>.npy  -- one file per leaf

A leaf's key is its dict path joined by ``/`` (``opt/m/embed``), its file
name the key with ``/`` replaced by ``__``.  A bfloat16 leaf is stored as
the JAX package stores it through numpy's extension dtype: two-byte void
elements (``<V2`` on disk) and ``"bfloat16"`` in the manifest; it is read
back through a 16-bit integer view into ``torch.bfloat16``.

- **Async**: the leaves are copied to the host at the call (so the next
  step's in-place update cannot race the writer), then a thread writes
  them, overlapping training with the I/O.
- **Atomic**: written into ``.tmp_step_<N>`` and renamed, the manifest
  last, so a crash mid-write never leaves a checkpoint that
  :func:`latest_step` sees.
- **Restore** places each leaf on the device and dtype of the matching
  leaf of ``like_state``; with ``shardings`` (a tree of resolved shardings
  on a mesh, ``distributed.sharding.placements``) each rank takes its
  slice of the leaf, so a checkpoint of one mesh restores onto another
  (the elastic path).
- **On a mesh** ``save_checkpoint`` goes leaf by leaf: each sharded leaf
  (m and v under ZeRO-1, the experts under expert parallelism) is
  gathered with ``all_gather``, the first rank writes its file in the same
  layout, and the whole copy is freed before the next leaf; every rank
  waits on a barrier until the checkpoint is there.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

SEP = "/"
BF16_DISK = np.dtype("V2")  # numpy's stand-in for an extension 2-byte dtype


def _flatten(tree, prefix: str = "") -> dict:
    """{key path: leaf} in the trees' sorted-key order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
        return out
    return {prefix[:-1]: tree}


def _treedef(tree) -> str:
    """The structure as the JAX package's manifest spells it (``str`` of a
    PyTreeDef): ``PyTreeDef({'a': *, 'b': {'c': *}})``."""
    def spell(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {spell(t[k])}" for k in sorted(t)) + "}"
        return "*"

    return f"PyTreeDef({spell(tree)})"


def _to_host(t) -> tuple[np.ndarray, str]:
    """(array to save, manifest dtype) of a leaf."""
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(BF16_DISK), "bfloat16"
    a = t.cpu().numpy()
    return a, str(a.dtype)


def _from_disk(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16" or arr.dtype == BF16_DISK:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _writer(mesh) -> bool:
    import torch.distributed as dist

    return mesh is None or dist.get_rank() == 0


def _begin(tmp: Path) -> None:
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)


def _write_leaf(tmp: Path, key: str, arr: np.ndarray) -> None:
    np.save(tmp / (key.replace(SEP, "__") + ".npy"), arr)


def _commit(tmp: Path, final: Path, step: int, meta: dict, treedef: str,
            extra: Optional[dict]) -> None:
    """The manifest (``meta``: key -> (shape, dtype)), then the rename."""
    manifest = {
        "step": step,
        "keys": sorted(meta),
        "shapes": {k: list(shape) for k, (shape, _) in meta.items()},
        "dtypes": {k: dt for k, (_, dt) in meta.items()},
        "treedef": treedef,
        "extra": extra or {},
    }
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)


def save_checkpoint(ckpt_dir, step: int, state, extra: Optional[dict] = None,
                    *, blocking: bool = True, shardings=None,
                    mesh=None) -> Optional[threading.Thread]:
    """Write ``state`` under <ckpt_dir>/step_<step>. Returns the writer
    thread (joined already when ``blocking``).  On a ``mesh`` the save is
    blocking and goes one leaf at a time: every rank gathers the leaf
    (``all_gather``, where ``shardings`` slices it), the first rank writes
    it, and the gathered copy is freed before the next leaf, so no rank
    ever holds more than one whole leaf beside its own slices (ZeRO-1's m
    and v stay sliced); every rank returns after a barrier, the others
    with None."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step}"
    tmp = ckpt_dir / f".tmp_step_{step}"
    if mesh is not None:
        _save_gathered(tmp, final, step, state, extra, shardings, mesh)
        return None
    host = {k: _to_host(v) for k, v in _flatten(state).items()}
    treedef = _treedef(state)

    def write() -> None:
        _begin(tmp)
        for k, (v, _) in host.items():
            _write_leaf(tmp, k, v)
        _commit(tmp, final, step, {k: (v.shape, dt) for k, (v, dt) in host.items()},
                treedef, extra)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    if blocking:
        t.join()
    return t


def _save_gathered(tmp: Path, final: Path, step: int, state, extra, shardings, mesh) -> None:
    import torch.distributed as dist

    from repro_torch.distributed.sharding import gather_leaf

    writer = _writer(mesh)
    flat_sh = _flatten(shardings) if shardings is not None else {}
    meta = {}
    if writer:
        _begin(tmp)
    for k, v in _flatten(state).items():  # sorted keys: the same collectives on every rank
        sh = flat_sh.get(k)
        whole = gather_leaf(v, sh, mesh) if sh is not None else v
        if writer:
            arr, dt = _to_host(whole)
            _write_leaf(tmp, k, arr)
            meta[k] = (arr.shape, dt)
            del arr
        del whole
    if writer:
        _commit(tmp, final, step, meta, _treedef(state), extra)
    dist.barrier()


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if (p / "MANIFEST.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, step: int, like_state, shardings=None,
                       mesh=None) -> tuple[Any, dict]:
    """Restore into the structure of ``like_state`` (a tree of tensors,
    e.g. a freshly built state, or of ``meta`` tensors): each leaf gets its
    like leaf's dtype and device (a ``meta`` leaf's: the mesh's device, or
    the CPU without a mesh).  ``shardings`` (a matching tree of
    resolved shardings on ``mesh``, the current mesh by default): each leaf
    is the rank's slice of the stored one, and ``like_state`` holds the
    slices' shapes.  Returns (state, the manifest's ``extra``).  A shape
    that does not match raises ValueError."""
    from repro_torch.distributed.sharding import current_mesh, local_shape, rank_slice

    src = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((src / "MANIFEST.json").read_text())
    dtypes = manifest.get("dtypes", {})
    flat_sh = _flatten(shardings) if shardings is not None else {}
    mesh = mesh if mesh is not None else current_mesh()

    def load(key: str, want):
        arr = np.load(src / (key.replace(SEP, "__") + ".npy"))
        sh = flat_sh.get(key)
        shape = local_shape(arr.shape, sh, mesh) if sh is not None else tuple(arr.shape)
        if shape != tuple(want.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {arr.shape} (here {shape}) != "
                             f"expected {tuple(want.shape)}")
        t = _from_disk(arr, dtypes.get(key, str(arr.dtype)))
        if sh is not None:
            t = rank_slice(t, sh, mesh)
        dev = want.device
        if dev.type == "meta":
            dev = mesh.device if mesh is not None else torch.device("cpu")
        return t.to(dev, want.dtype)

    def rebuild(t, prefix: str):
        if isinstance(t, dict):
            return {k: rebuild(t[k], f"{prefix}{k}{SEP}") for k in sorted(t)}
        return load(prefix[:-1], t)

    return rebuild(like_state, ""), manifest.get("extra", {})


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; saves asynchronously every
    ``interval`` steps, one write in flight at a time.  On a ``mesh``
    (with the state's ``shardings``) each save gathers leaf by leaf, the
    first rank writes, and the save blocks every rank."""

    def __init__(self, ckpt_dir, *, interval: int = 100, keep: int = 3,
                 shardings=None, mesh=None) -> None:
        self.dir = Path(ckpt_dir)
        self.interval = interval
        self.keep = keep
        self.shardings = shardings
        self.mesh = mesh
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, state, extra: Optional[dict] = None) -> bool:
        if step % self.interval:
            return False
        if self._pending is not None:
            self._pending.join()  # backpressure: one in flight
        if self.mesh is not None:
            save_checkpoint(self.dir, step, state, extra, shardings=self.shardings,
                            mesh=self.mesh)
            if _writer(self.mesh):
                self._gc()
            return True
        self._pending = save_checkpoint(self.dir, step, state, extra, blocking=False)
        self._gc(in_flight=step)
        return True

    def finalize(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self, in_flight: Optional[int] = None) -> None:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                       if (p / "MANIFEST.json").exists())
        if in_flight is not None and in_flight not in steps:
            steps = sorted(steps + [in_flight])  # count the async write
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
