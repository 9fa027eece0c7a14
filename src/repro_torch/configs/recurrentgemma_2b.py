"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern
(rec, rec, attn). [arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,  # 26 blocks: ceil-repeat of (rec, rec, attn)
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256000,
        window=2048,
        block_pattern=("rec", "rec", "attn"),
        lru_width=2560,
        tie_embeddings=True,
        remat="dots",
    )
)
