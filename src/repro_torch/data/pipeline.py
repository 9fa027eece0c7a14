"""Data pipeline: a deterministic synthetic token stream and a prefetching
loader onto one device.

- ``SyntheticTokens`` -- seeded, reproducible LM batches (zipf-ish
  marginals so losses are non-degenerate), resumable via ``state()`` /
  ``seek()``: the checkpoint manifest stores the cursor, so a restart is
  bit-identical.  The draws are the JAX package's, ``np.random.default_rng
  ((seed, cursor))`` in its order, so both packages' batches are equal bit
  for bit, ``patches`` and ``frames`` included.
- ``DeviceLoader`` -- the reference ``ShardedLoader``'s prefetch thread
  (``depth`` batches ahead, the host-side analogue of the engine's
  transfer/compute overlap) placing each host batch on one device.  Its
  mesh placement comes with the device mesh (ROADMAP.md A11).
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

    def _worker(self) -> None:
        try:
            for batch in self.source:
                if self._stop.is_set() or not self._put(to_device(batch, self.device)):
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
