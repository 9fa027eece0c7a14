"""qwen1.5-4b [dense] — QKV bias, large vocab. [hf:Qwen/Qwen1.5-4B family]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_ff=6912,
        vocab=151936,
        qkv_bias=True,
        rope_theta=1e6,
        remat="dots",
    )
)
