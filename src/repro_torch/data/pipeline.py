"""Data pipeline: a deterministic synthetic token stream and prefetching
loaders onto a device or a mesh.

- ``SyntheticTokens`` -- seeded, reproducible LM batches (zipf-ish
  marginals so losses are non-degenerate), resumable via ``state()`` /
  ``seek()``: the checkpoint manifest stores the cursor, so a restart is
  bit-identical.  The draws are the JAX package's, ``np.random.default_rng
  ((seed, cursor))`` in its order, so both packages' batches are equal bit
  for bit, ``patches`` and ``frames`` included.
- ``DeviceLoader`` -- the reference ``ShardedLoader``'s prefetch thread
  (``depth`` batches ahead, the host-side analogue of the engine's
  transfer/compute overlap) placing each host batch on one device.
- ``ShardedLoader`` -- the same, placing on each rank of a mesh its slice
  of every host batch, by the inputs' logical entries
  (``launch.specs.input_specs``: the batch dim over the batch axes).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class SyntheticTokens:
    def __init__(self, cfg, batch: int, seq: int, seed: int = 0) -> None:
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self._cursor = 0

    def state(self) -> dict:
        return {"seed": self.seed, "cursor": self._cursor}

    def seek(self, cursor: int) -> None:
        self._cursor = cursor

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self._cursor))
        self._cursor += 1
        cfg = self.cfg
        # Zipf-flavoured token ids: a realistic skewed unigram distribution.
        z = rng.zipf(1.3, size=(self.batch, self.seq))
        tokens = np.minimum(z - 1, cfg.vocab - 1).astype(np.int32)
        batch = {"tokens": tokens}
        if cfg.family == "vlm":
            batch["patches"] = rng.normal(size=(self.batch, cfg.n_patches, cfg.d_model)).astype(
                np.float32)
        if cfg.family == "audio":
            batch["frames"] = rng.normal(size=(self.batch, cfg.enc_frames, cfg.d_model)).astype(
                np.float32)
        return batch


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy) as tensors on ``device``, dtypes kept."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


class DeviceLoader:
    """Places host batches on ``device``; prefetches ``depth`` batches ahead
    on a thread of its own.  ``close()`` stops the thread."""

    def __init__(self, source: Iterator[dict], device, depth: int = 2) -> None:
        self.source = source
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Enqueue unless stopped (polling, so a full queue never strands
        the thread after ``close``)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _place(self, batch: dict) -> dict:
        return to_device(batch, self.device)

    def _worker(self) -> None:
        try:
            for batch in self.source:
                if self._stop.is_set() or not self._put(self._place(batch)):
                    return
        finally:
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


class ShardedLoader(DeviceLoader):
    """Places on this rank of ``mesh`` its slice of every host batch, by
    ``entries`` (key -> logical entries, ``launch.specs.input_specs``),
    on the mesh's device; prefetches ``depth`` batches ahead.  Without a
    mesh, the whole batch on ``device``."""

    def __init__(self, source: Iterator[dict], mesh, entries: dict, device=None,
                 depth: int = 2) -> None:
        self.mesh = mesh
        self.entries = entries
        super().__init__(source, mesh.device if mesh is not None else device, depth)

    def _place(self, batch: dict) -> dict:
        return rank_batch(batch, self.mesh, self.entries, self.device)


def rank_batch(batch: dict, mesh, entries: dict, device) -> dict:
    """This rank's slice of a host batch (numpy) on ``device``, each key's
    dims split by its logical ``entries`` on ``mesh`` (the whole batch
    without one)."""
    from repro_torch.distributed.sharding import named_sharding, rank_slice

    if mesh is None:
        return to_device(batch, device)
    out = {}
    for k, v in batch.items():
        v = torch.from_numpy(np.asarray(v))
        sh = named_sharding(mesh, tuple(entries[k]), tuple(v.shape))
        out[k] = rank_slice(v, sh, mesh).to(device)
    return out
