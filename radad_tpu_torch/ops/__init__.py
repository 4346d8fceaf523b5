"""Counterpart: ``radad_tpu/ops/__init__.py``."""
