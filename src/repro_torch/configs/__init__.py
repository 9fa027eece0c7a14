"""Architecture configs. Importing this package registers the ported archs."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeCell,
    all_archs,
    cell_applicable,
    get_config,
)

# Register the ported architectures (import side effects).
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    codeqwen15_7b,
    falcon_mamba_7b,
    granite_34b,
    internlm2_20b,
    kimi_k2_1t,
    paligemma_3b,
    qwen15_4b,
    recurrentgemma_2b,
    whisper_tiny,
)
from repro_torch.configs.reduced import reduced  # noqa: F401
