"""paligemma-3b [vlm] — gemma-2b backbone + SigLIP frontend (STUB: input_specs
provides precomputed patch embeddings). [arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=257216,
        tie_embeddings=True,
        n_patches=256,  # 224px / 14 patch = 16x16 SigLIP patches
        remat="dots",
    )
)
