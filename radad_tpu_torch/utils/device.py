"""Device resolution and numeric precision for the port's entry points.

Counterpart: none in ``radad_tpu`` (JAX places arrays on its default
backend). Entry points take ``device="cuda"`` by default and raise when no
GPU is present unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def set_precision_flags() -> None:
    """True f32 matmuls and convolutions, f32 accumulation for bf16
    products. The certified search's error margin
    (``index/flat.py::_search_fast_exact``) assumes f32 accumulation, and
    cuDNN would otherwise run wav2vec2's f32 conv stack in TF32. These are
    process-wide PyTorch settings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device (torch.cuda.is_available() is False); pass "
                "device='cpu' to run the port on the CPU")
        set_precision_flags()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
