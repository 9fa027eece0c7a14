"""Model zoo registry: a uniform API over the ported families.

    api = get_model(cfg)
    api.param_spec(cfg, par)              -> Spec tree
    api.cache_spec(cfg, batch, seq, par)  -> Spec tree (decode caches)
    api.forward_train(params, batch, cfg) -> scalar loss
    api.prefill(params, batch, cfg, cache)-> (logits, cache)
    api.decode(params, token, pos, cfg, cache) -> (logits, cache)
    api.prefill_chunk(params, tokens, posv, valid, cfg, cache, last_idx)
        -> (logits, cache)   # chunked prefill; None when the family has
                             # no chunked path (validate_chunked gates
                             # serving accordingly)
    api.model_sliced(cfg, mesh)           -> {"params": paths, "cache": paths,
                                              "parts": {path: blocks}}
                             # the whole key paths of the leaves a model
                             # rank holds a slice of over "model", and
                             # those sliced in blocks (sharding.Parts)
                             # (distributed.sharding.rank_placements)
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

KERNEL_IMPLS = ("reference", "cuda")


class ModelAPI(NamedTuple):
    param_spec: Callable
    cache_spec: Callable
    prefill: Callable
    decode: Callable
    prefill_chunk: Optional[Callable] = None
    forward_train: Optional[Callable] = None
    model_sliced: Optional[Callable] = None


def get_model(cfg) -> ModelAPI:
    if cfg.kernel_impl not in KERNEL_IMPLS:
        raise ValueError(f"kernel_impl {cfg.kernel_impl!r} is not one of {KERNEL_IMPLS}")
    if cfg.family in ("dense", "moe", "ssm", "vlm"):
        from repro_torch.models import transformer as T

        # Chunked prefill of a prefix-LM prompt is not ported: the server,
        # its only caller, refuses the vlm family.
        chunk = T.prefill_chunk if cfg.family in ("dense", "moe") else None
        return ModelAPI(T.param_spec, T.cache_spec, T.prefill, T.decode, chunk,
                        forward_train=T.forward_train, model_sliced=T.model_sliced)
    if cfg.family == "hybrid":
        from repro_torch.models import rglru as R

        return ModelAPI(R.param_spec, R.cache_spec, R.prefill, R.decode,
                        forward_train=R.forward_train, model_sliced=R.model_sliced)
    if cfg.family == "audio":
        from repro_torch.models import whisper as W

        return ModelAPI(W.param_spec, W.cache_spec, W.prefill, W.decode,
                        forward_train=W.forward_train, model_sliced=W.model_sliced)
    raise ValueError(f"unknown family {cfg.family!r}")
