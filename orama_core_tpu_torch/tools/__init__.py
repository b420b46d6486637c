"""Command-line tools of the port, each run as ``python -m
orama_core_tpu_torch.tools.<name>``: ``train_tiny_encoder`` (train and
export the semantic test checkpoint), ``prepare_checkpoint`` (validate a
local HF checkpoint and print its config stanza) and ``warm_cache``
(build the kernels and the device caches ahead of serving). Each runs on
the card unless given ``--device cpu``."""
