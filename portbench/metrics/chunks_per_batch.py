"""Memory chunks of the fused batch program per ``search_batch`` call in
the window: the ``chunks`` field of the program's ``search_batch``
spans (each chunk holds its rows' dense scores over the corpus)."""

from portbench import spans


def install(w):
    spans.install()


def read(w):
    c = [s["fields"]["chunks"] for s in spans.named(w, "search_batch") or []
         if "chunks" in s["fields"]]
    return sum(c) / len(c) if c else None
