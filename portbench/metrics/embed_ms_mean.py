"""Host time of the query embedder per ``search_batch`` call in the
window: the program's ``search_batch.embed`` phases, in ms."""

from portbench import spans


def install(w):
    spans.install()


def read(w):
    return spans.per_batch_ms(w, "search_batch.embed")
