"""Model inputs: their abstract shapes, their logical shardings, and
synthetic batches.

``input_specs(cfg, shape)`` returns (abstract tree, logical entry tree) of
the step inputs of a cell kind, the abstract leaves ``meta`` tensors (no
allocation):

    train   : {"tokens": (B, S) int32}  (+ patches / frames for vlm / audio)
    prefill : the same as train (the prompt batch)
    decode  : {"token": (B, 1) int32, "pos": () int32}; the cache comes apart
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCell


def effective_seq(cfg: ModelConfig, shape: ShapeCell) -> int:
    """The cell's sequence length, capped at ``max_decode_ctx``."""
    s = shape.seq_len
    if cfg.max_decode_ctx:
        s = min(s, cfg.max_decode_ctx)
    return s


def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype), device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeCell):
    b = shape.global_batch
    s = effective_seq(cfg, shape)
    if shape.kind in ("train", "prefill"):
        abstract = {"tokens": _meta((b, s), "int32")}
        pspec = {"tokens": ("batch", None)}
        if cfg.family == "vlm":
            abstract["patches"] = _meta((b, cfg.n_patches, cfg.d_model), cfg.compute_dtype)
            pspec["patches"] = ("batch", None, None)
        if cfg.family == "audio":
            abstract["frames"] = _meta((b, cfg.enc_frames, cfg.d_model), cfg.compute_dtype)
            pspec["frames"] = ("batch", None, None)
        return abstract, pspec
    if shape.kind == "decode":
        return ({"token": _meta((b, 1), "int32"), "pos": _meta((), "int32")},
                {"token": ("batch", None), "pos": ()})
    raise ValueError(shape.kind)


def make_batch(cfg: ModelConfig, shape: ShapeCell, seed: int,
               batch_override: int | None = None) -> dict:
    """A synthetic prompt batch as numpy, drawn from ``seed`` in the JAX
    package's order: ``{"tokens": (B, S) int32}``, then the vlm family's
    ``patches`` (B, n_patches, d) or the audio family's ``frames``
    (B, enc_frames, d), standard normal in float32 (the stubbed SigLIP and
    conv frontends' outputs).  S is capped at ``max_decode_ctx``."""
    b = batch_override or shape.global_batch
    s = effective_seq(cfg, shape)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch
