"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free. [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=65024,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        remat="full",
    )
)
