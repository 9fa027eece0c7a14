"""PyTorch/CUDA port of the ``repro`` JAX package, for one NVIDIA H100.

The package keeps the JAX package's module and public function names and
its tensor layouts at the public functions; it imports torch, numpy and the
standard library only.  Its entry points run on ``cuda`` unless the caller
asks for the CPU, and raise when CUDA is missing and the CPU was not asked
for.

A float32 matrix product must stay float32 on the card, as it is in the
reference: TF32 keeps about three decimal digits, far outside the
tolerances the parity tests hold the port to.  Both switches are set here,
once, for every user of the package.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``"cpu"`` was
    asked for.  Raises when CUDA was asked for and is missing."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev
