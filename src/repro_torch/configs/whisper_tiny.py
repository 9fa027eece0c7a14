"""whisper-tiny [audio] — enc-dec, conv frontend STUB (input_specs provides
precomputed 1500-frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,  # decoder layers
        enc_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51865,
        enc_frames=1500,
        max_decode_ctx=448,
        tie_embeddings=True,
        norm_eps=1e-5,
    )
)
