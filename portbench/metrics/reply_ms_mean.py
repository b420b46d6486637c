"""Host time of one ``search_batch`` call's replies, mean over the calls
in the window, in ms: its ``search_batch.reply`` phases (the (doc,
score) lists, built on the collector's thread), plus the time from the
call's end until the last of its requests has its hits (the program's
``read_side.hits`` spans on the clients' threads: ids to hits, after the
client wakes). The clients build their hits in parallel threads, so the
second part is wall time, not the sum of their spans."""

from portbench import spans


def install(w):
    spans.install()


def read(w):
    calls = spans.named(w, "search_batch")
    if not calls:
        return None
    reply, hits_end, batch_of = {}, {}, {}
    for s in spans.named(w, "search_batch.reply") or []:
        reply[s["parent"]] = reply.get(s["parent"], 0.0) + spans.ms(s)
    for s in spans.named(w, "read_side.hits") or []:
        hits_end[s["parent"]] = s["end_ns"]
    for q in spans.named(w, "batcher.queued") or []:
        if q["parent"] in hits_end:
            b = q["fields"]["batch"]
            batch_of[b] = max(batch_of.get(b, 0), hits_end[q["parent"]])
    ms = [reply[c["id"]] + max(0, batch_of[c["parent"]] - c["end_ns"]) / 1e6
          for c in calls if c["id"] in reply and c["parent"] in batch_of]
    return sum(ms) / len(ms) if ms else None
