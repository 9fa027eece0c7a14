"""Synthetic model inputs."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCell


def make_batch(cfg: ModelConfig, shape: ShapeCell, seed: int,
               batch_override: int | None = None) -> dict:
    """A synthetic prompt batch: ``{"tokens": (B, S) int32}`` as numpy,
    drawn from ``seed``.  Only the dense family is ported, so there are no
    patches or frames."""
    b = batch_override or shape.global_batch
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, shape.seq_len)).astype(np.int32)}
