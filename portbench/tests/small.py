"""A cell cut to a size that a CPU test run holds, and one run of it."""

from __future__ import annotations

import copy
import dataclasses
import time

from portbench import cell, spec


def small_cell(name: str, n_docs: int = 20_000, n_terms: int = 2_000,
               clients: int = 8) -> spec.Cell:
    c = spec.cell(name)
    cfg, mix = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg["n_docs"] = n_docs
    if "text" in cfg:
        cfg["text"]["n_terms"] = n_terms
    mix.update(clients=clients, requests_per_client=16, vocab_terms=n_terms,
               check_sample=40, keep_every=2)
    return dataclasses.replace(c, config=cfg, traffic=mix)


def run_small(name: str, seed: int = 3, traced: bool = False, serving=None,
              seconds: float = 1.5, **kw):
    import torch

    torch.set_num_threads(2)
    return cell.run_cell(small_cell(name, **kw), seed, seconds, traced, "cpu",
                         time.perf_counter(), serving=serving,
                         log=lambda *a: None)
