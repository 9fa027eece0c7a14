"""granite-34b [dense] — llama-arch code model, MQA (kv=1). [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        rope_theta=1e4,
        param_dtype="float32",
        remat="full",
    )
)
