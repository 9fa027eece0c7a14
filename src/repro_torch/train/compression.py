"""Gradient compression for the cross-group reduction (int8 + error
feedback), as the JAX package's ``train/compression.py``.

int8 quantization cuts the bytes of a gradient 4x against float32; error
feedback (Seide et al.) adds each step's quantization residual into the
next step's gradient, so that the compressed trajectory tracks the exact
one.  Used by the heterogeneous trainer's host-side combine.  Trees are
nested dicts of tensors (``models.params.tree_map``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.params import tree_map


def quantize(g):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def compress_tree(grads):
    return tree_map(quantize, grads)


def decompress_tree(qtree):
    return tree_map(lambda qs: dequantize(*qs), qtree)


class ErrorFeedback:
    """Residual accumulator: compress(g + e); e' = (g + e) - decompress(...)."""

    def __init__(self) -> None:
        self._residual: Optional[Any] = None

    def compress(self, grads):
        if self._residual is not None:
            grads = tree_map(torch.add, grads, self._residual)
        qtree = compress_tree(grads)
        deq = decompress_tree(qtree)
        self._residual = tree_map(torch.sub, grads, deq)
        return qtree

    def reset(self) -> None:
        self._residual = None
