"""Config system: model configs, shape cells, and the registry.

A copy of the JAX package's ``configs/base.py``: the port imports nothing of
that package, so both keep their own definition of the same dataclass and
the tests hold the two field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False  # arctic: dense MLP branch in parallel with MoE
    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- hybrid (recurrentgemma) ---
    window: int = 0  # local-attention window; 0 = full attention
    block_pattern: tuple = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    # --- modality stubs ---
    n_patches: int = 0  # vlm: SigLIP patch embeddings provided by input_specs
    enc_layers: int = 0  # audio: encoder depth
    enc_frames: int = 0  # audio: frames after the (stubbed) conv frontend
    max_decode_ctx: int = 0  # hard cap on decoder context (whisper: 448)
    # --- numerics / perf knobs ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"  # none | dots | full
    scan_layers: bool = True
    kernel_impl: str = "reference"  # reference (dense torch) | cuda (the port's kernels)
    zero1: bool = False  # shard optimizer state over the data axis
    logits_chunk: int = 0  # chunked-vocab loss; 0 = dense logits
    microbatches: int = 1  # gradient-accumulation splits per step
    fused_attention: bool = False  # force online-softmax attention at every length
    cache_dtype: str = ""  # KV cache storage dtype ("" = compute_dtype)
    analysis_unroll: bool = False  # JAX roofline-analysis lowering; unused here
    decode_block: int = 0  # decode-attention KV tile size (0 = kernel default of 128)
    seq_shard_cache: bool = False  # decode: KV cache timeline sharded over "model"
    ep_shard_map: bool = False  # MoE: expert-parallel dispatch over "model"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k context (O(L) memory per token)?"""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.window > 0:
            return True
        return False


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: O(L^2) attention / 500k KV cache not servable (DESIGN.md §4)"
    return True, ""


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def all_archs() -> list[str]:
    from repro_torch import configs as _c  # noqa: F401

    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    # Import for side effect: populate the registry.
    from repro_torch import configs as _c  # noqa: F401

    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
