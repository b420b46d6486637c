"""Port of ``orama_core_tpu/server/__init__.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``."""

