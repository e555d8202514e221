"""Everything of one cell, found by name from ``BENCHMARK.json``.

* the configuration: the file its entry names (``configs/<name>.json``);
* the traffic mix: ``traffic/<traffic>.json``, parameters read by the
  loop module it names: ``loops/<loop>.py`` (``KEYS``, ``directions``,
  ``analysis``, ``judge``);
* the limits of the correctness check: ``limits/<cell>.json``;
* the program's case: ``cases/<case>.py`` (the configuration's ``case``);
* the plain reference: ``reference/<reference>.py``;
* each per-layer metric: ``metrics/<name>.py``, with the module constants
  ``LAYER``, ``UNIT``, ``BETTER``, ``SOURCE``, ``MOVES`` and ``read(run)``.

A new cell, configuration, traffic mix, loop or metric is a new file and
a new entry: nothing here lists them.  A traffic mix may hold only the
keys that the harness and its loop read (``TRAFFIC_KEYS`` and the loop's
``KEYS``): a key that nothing reads is refused, not ignored.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # bench_port/


@dataclasses.dataclass
class Cell:
    root: str  # the checkout's root, where BENCHMARK.json is
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType]
    loop: ModuleType

    def case_module(self) -> ModuleType:
        return importlib.import_module(f"bench_port.cases.{self.config['case']}")

    def reference_module(self) -> ModuleType:
        return importlib.import_module(f"bench_port.reference.{self.config['reference']}")

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# what the harness reads of every traffic mix
TRAFFIC_KEYS = {"name", "loop", "start_outside_sponge", "traced_applications",
                "checked_applications", "why"}


def _module(kind: str, name: str, bench_dir: str) -> ModuleType:
    path = os.path.join(bench_dir, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_port_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = HERE) -> ModuleType:
    """The reader module of a per-layer metric (its name may hold dots)."""
    return _module("metrics", name, bench_dir)


def traffic_loop(traffic: dict, bench_dir: str = HERE) -> ModuleType:
    """The loop module a traffic mix names, after refusing any key of the
    mix that neither the harness nor that loop reads."""
    loop = _module("loops", traffic["loop"], bench_dir)
    unread = set(traffic) - TRAFFIC_KEYS - loop.KEYS
    if unread:
        raise ValueError(f"traffic {traffic['name']!r}: keys nothing reads: {sorted(unread)}")
    return loop


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: str, name: str, bench_dir: str = HERE) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    per_layer = [m for m in bench["per_layer"] if applies(m, name)]
    readers = {m["name"]: metric_reader(m["name"], bench_dir) for m in per_layer}
    return Cell(root=root, name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=per_layer, readers=readers, loop=traffic_loop(traffic, bench_dir))
