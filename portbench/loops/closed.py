"""The closed loop: each client sends its next request when its reply comes.

``clients`` threads stand for application servers whose workers each wait
on a reply; client c sends its requests in turn, the next when the
previous reply has come, until the window closes. The loop keeps the
replies to every ``keep_every``-th request of a client from its offset,
and every failure.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Tuple


class Loop:
    def __init__(self, search, params, kept, keep_every: int,
                 mix: Dict[str, Any]) -> None:
        self.search = search
        self.params = params
        self.kept = kept
        self.keep_every = keep_every
        self.t_end = math.inf
        # per client: (t_call, t_ret, ok, n) of its n-th request
        self.records: List[List[Tuple[float, float, bool, int]]] = [
            [] for _ in params]
        self.replies: Dict[Tuple[int, int], Any] = {}
        self.threads = [threading.Thread(target=self._client, args=(c,),
                                         daemon=True) for c in range(len(params))]

    def _client(self, c: int) -> None:
        reqs, rec = self.params[c], self.records[c]
        n = 0
        while True:
            t = time.perf_counter()
            if t >= self.t_end:
                return
            try:
                reply, ok = self.search(reqs[n % len(reqs)]), True
            except Exception as e:  # a failed request is recorded, not fatal
                reply, ok = e, False
            rec.append((t, time.perf_counter(), ok, n))
            if not ok or (n - self.kept[c]) % self.keep_every == 0:
                self.replies[(c, n)] = reply
            n += 1

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def warm(self, rounds: int, timeout_s: float) -> None:
        """Waits until every client has had ``rounds`` replies."""
        deadline = time.perf_counter() + timeout_s
        while min(len(r) for r in self.records) < rounds:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"warm-up: not every client finished {rounds} "
                                   f"requests in {timeout_s} s")
            time.sleep(0.01)

    def close(self, t_end: float, timeout_s: float) -> None:
        """Ends the loop at ``t_end`` and waits for the requests in flight."""
        self.t_end = t_end
        for t in self.threads:
            t.join(timeout=max(0.0, t_end + timeout_s - time.perf_counter()))
        alive = sum(t.is_alive() for t in self.threads)
        if alive:
            raise TimeoutError(f"{alive} clients still waiting {timeout_s} s "
                               "after the window closed")
