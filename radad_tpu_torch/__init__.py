"""PyTorch/CUDA port of ``radad_tpu`` for NVIDIA Hopper (H100).

Counterpart: ``radad_tpu/__init__.py``. The serving path (decode → segment
→ wav2vec2 → TPP → certified-exact flat search → neighbor gather → fusion
model) is ported; its three TPU kernels are hand-written CUDA under
``radad_tpu_torch/csrc``. The package imports ``torch`` and never JAX or
anything of ``radad_tpu``.
"""

__version__ = "0.1.0"
