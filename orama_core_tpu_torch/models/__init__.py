"""Port of ``orama_core_tpu/models/__init__.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``."""

