"""Device time of the fused batch program's rank phase per request
answered in the window, in ms: the CUDA event pairs of the program's
``fused.rank`` spans (RRF's candidate ranks, or min-max, then the top-k
and counts). Events time the stream from the phase's first to its last
kernel, so a wait on the host's enqueue inside the phase counts."""

from portbench import spans


def install(w):
    spans.install()


def read(w):
    return spans.device_ms_per_query(w, "fused.rank")
