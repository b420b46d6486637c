"""Device ops of the port: plain torch tensor code plus the wrappers of the
hand-written Hopper kernels (``csrc/``). Port of ``orama_core_tpu/ops``;
``pallas_knn.py`` is ``knn.py`` here."""

from . import (  # noqa: F401
    bm25,
    facets,
    filters,
    fusion,
    knn,
    topk,
    vector,
)
