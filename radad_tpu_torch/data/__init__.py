"""Counterpart: ``radad_tpu/data/__init__.py``."""
