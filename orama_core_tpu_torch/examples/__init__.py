"""Examples of the port's library surface, each run as ``python -m
orama_core_tpu_torch.examples.<name> [--device cpu]`` (the card by
default): ``quickstart`` (index and search every mode), ``serving``
(micro-batching, selective filters, raw-vector queries) and
``multilingual`` (per-locale analysis and stem expansion). Each ``main``
prints what it found and returns it."""
