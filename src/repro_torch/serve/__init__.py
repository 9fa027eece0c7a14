"""Serving: prefill/decode steps, decode chains and one-shot generate."""
from repro_torch.serve.step import (  # noqa: F401
    cast_params_cached,
    make_decode_chain,
    make_decode_step,
    make_generate,
    make_prefill_step,
    zeros_cache,
)
