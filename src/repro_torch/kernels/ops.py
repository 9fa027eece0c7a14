"""Public wrappers for the port's kernels.

Each wrapper launches its CUDA kernel on CUDA tensors (or raises) and runs
its plain PyTorch version on CPU tensors.  Models select the kernels with
``cfg.kernel_impl = "cuda"``.  ``launch_counts()`` reads, and
``reset_launch_counts()`` zeroes, the number of kernel launches so far;
``multi_row_counts()`` reads how many of the decode kernels' launches ran
more than one query row a slot.
"""
from repro_torch.kernels._build import LAUNCHES, MULTI_ROW
from repro_torch.kernels._build import reset_launches as reset_launch_counts  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: F401
from repro_torch.kernels.flash_decode import (  # noqa: F401
    flash_decode,
    flash_decode_chunk,
    flash_decode_paged,
    needed_tiles,
)
from repro_torch.kernels.gemm import linear  # noqa: F401
from repro_torch.kernels.layer_norm import layer_norm  # noqa: F401
from repro_torch.kernels.moe_gemm import moe_gemm  # noqa: F401
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: F401
from repro_torch.kernels.rms_norm import rms_norm  # noqa: F401
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: F401


def launch_counts() -> dict:
    return dict(LAUNCHES)


def multi_row_counts() -> dict:
    return dict(MULTI_ROW)
