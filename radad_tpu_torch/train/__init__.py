"""Counterpart: ``radad_tpu/train/__init__.py``."""
