"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8.
[arXiv:2501.kimi2; unverified paper-table config]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=112,
        d_ff=2048,  # per-expert FFN width
        vocab=163840,
        n_experts=384,
        top_k=8,
        rope_theta=5e6,
        param_dtype="bfloat16",  # 1T params: fp32 master impossible at 512 chips
        zero1=True,
        remat="full",
    )
)
