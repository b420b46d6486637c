"""Mean of the program's ``batcher.fill`` spans in the window, in ms: the
micro-batcher's collector, from taking a batch's first request to running
its first group (the wait for more requests, up to ``batch_wait_ms``)."""

from portbench import spans


def install(w):
    spans.install()


def read(w):
    f = spans.named(w, "batcher.fill")
    return sum(spans.ms(s) for s in f) / len(f) if f else None
