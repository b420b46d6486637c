"""Mean wall time of one ``CollectionReader.search_batch`` call (it returns
host lists, so the call ends when its batch's device work has), over the
calls that start in the window, in ms."""


def read(w):
    ms = [(e - t) * 1e3 for t, e, _c in w.batches if w.t0 <= t < w.t1]
    return sum(ms) / len(ms) if ms else None
