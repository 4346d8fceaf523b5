"""Counterpart: ``radad_tpu/index/__init__.py``."""
