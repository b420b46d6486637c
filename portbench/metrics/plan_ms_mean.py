"""Host time of plan building per ``search_batch`` call in the window: the
program's ``search_batch.plan`` phases (query expansion, the dense-row
split, the block plans, the weight rows, staging and uploads), in ms."""

from portbench import spans


def install(w):
    spans.install()


def read(w):
    return spans.per_batch_ms(w, "search_batch.plan")
