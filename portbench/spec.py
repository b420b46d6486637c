"""Find a cell's parts by the names in ``BENCHMARK.json``.

- configuration: ``BENCHMARK.json``'s ``file`` (``portbench/configs/<config>.json``),
  whose ``generator`` and ``reference`` keys name modules of
  ``portbench/generators/`` and ``portbench/reference/``;
- traffic mix: ``portbench/traffic/<traffic>.json``, whose ``loop`` key
  names a module of ``portbench/loops/`` and each of whose request kinds
  names its ``comparison``, a module of ``portbench/comparisons/``;
- limits of the comparison that decides ``correct``:
  ``portbench/limits/<workload>.json``;
- per-layer metric: its reader ``portbench/metrics/<metric>.py``;
- kernel roofline: ``portbench/roofline/<kernel>.py``, which its metric's
  reader imports.

A metric or module name maps to a file name with ``.`` and ``-`` read as
``_``. Adding a cell, mix or metric adds files and entries; nothing here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any, Dict, List

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def module_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _named(entries: List[Dict[str, Any]], name: str, what: str):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, read."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]      # the configuration's file
    traffic_name: str
    traffic: Dict[str, Any]     # the traffic mix's file
    limits: Dict[str, float]    # the comparison's limits
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def cell(name: str, root: str = ROOT) -> Cell:
    bench = load_benchmark(root)
    w = _named(bench["workloads"], name, "workload")
    c = _named(bench["configs"], w["config"], "configuration")
    pkg = os.path.join(root, "portbench")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=c["name"],
        config=_read_json(os.path.join(root, c["file"])),
        traffic_name=w["traffic"],
        traffic=_read_json(os.path.join(pkg, "traffic", w["traffic"] + ".json")),
        limits=_read_json(os.path.join(pkg, "limits", module_name(name) + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def generator(name: str):
    return importlib.import_module(f"portbench.generators.{module_name(name)}")


def reference(name: str):
    return importlib.import_module(f"portbench.reference.{module_name(name)}")


def loop(name: str):
    return importlib.import_module(f"portbench.loops.{module_name(name)}")


def comparison(name: str):
    return importlib.import_module(f"portbench.comparisons.{module_name(name)}")


def metric_reader(name: str):
    return importlib.import_module(f"portbench.metrics.{module_name(name)}")

