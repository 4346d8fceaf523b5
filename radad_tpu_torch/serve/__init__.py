"""Counterpart: ``radad_tpu/serve/__init__.py``."""
