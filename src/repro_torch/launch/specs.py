"""Synthetic model inputs."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCell


def make_batch(cfg: ModelConfig, shape: ShapeCell, seed: int,
               batch_override: int | None = None) -> dict:
    """A synthetic prompt batch as numpy, drawn from ``seed`` in the JAX
    package's order: ``{"tokens": (B, S) int32}``, then the vlm family's
    ``patches`` (B, n_patches, d) or the audio family's ``frames``
    (B, enc_frames, d), standard normal in float32 (the stubbed SigLIP and
    conv frontends' outputs).  S is capped at ``max_decode_ctx``."""
    b = batch_override or shape.global_batch
    s = min(shape.seq_len, cfg.max_decode_ctx) if cfg.max_decode_ctx else shape.seq_len
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch
