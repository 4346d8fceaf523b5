"""Counterpart: ``radad_tpu/models/__init__.py``."""
