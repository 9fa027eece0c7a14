"""arctic-480b [moe] — 128 experts top-2 + dense residual branch.
[hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab=32000,
        n_experts=128,
        top_k=2,
        dense_residual=True,
        param_dtype="bfloat16",
        zero1=True,
        remat="full",
    )
)
