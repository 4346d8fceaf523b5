"""Counterpart: ``radad_tpu/utils/__init__.py``."""
