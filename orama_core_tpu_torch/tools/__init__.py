"""Command-line tools of the port, each run as ``python -m
orama_core_tpu_torch.tools.<name>``: ``train_tiny_encoder`` (train and
export the semantic test checkpoint), ``prepare_checkpoint`` (validate a
local HF checkpoint and print its config stanza), ``warm_cache`` (build
the kernels and the device caches ahead of serving), the kernel probes
``knn_tune_bench`` and ``bm25_scan_bench`` (the counterparts of
``benchmarks/``' Pallas variants; ``timing`` holds the clock and
bounds of every kernel record, ``chip_smoke.py``'s too) and ``sass_diff``
(K1's, K2's and K6's machine code against another tree's). Each runs on the card unless given ``--device cpu``; ``sass_diff``
needs only the CUDA toolkit."""
