"""PyTorch/CUDA port of ``radad_tpu`` for NVIDIA Hopper (H100).

Counterpart: ``radad_tpu/__init__.py``. The serving path (decode → segment
→ wav2vec2/HuBERT, WavLM or Whisper → TPP → certified-exact or
``flat_topk`` flat search, or the SQ8 index → neighbor gather → fusion
model), training, mixed precision and the native audio decoder are
ported; the five TPU kernels are hand-written CUDA under
``radad_tpu_torch/csrc``. The package imports ``torch`` and never JAX
or anything of ``radad_tpu``.
"""

__version__ = "0.1.0"
