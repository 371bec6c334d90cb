"""Finds everything of a cell by name: its entry in ``BENCHMARK.json``,
``configs/<config>.json``, ``workloads/<cell>.json``,
``mixes/<mix>.json``, ``traffic/<loop>.py`` and one
``metrics/<metric>.py`` reader per metric. A later change adds a
configuration, a mix, a cell or a metric by adding such files and
entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        "fnsbench_" + path.parent.name + "_" + path.stem.replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    mix: dict
    loop: object              # the traffic module
    end_to_end: list          # BENCHMARK.json metric entries
    per_layer: list
    readers: dict             # metric name -> read(record)


class Bench:
    def __init__(self, root: pathlib.Path = HERE,
                 benchmark: pathlib.Path = BENCHMARK):
        self.root = pathlib.Path(root)
        self.spec = json.loads(pathlib.Path(benchmark).read_text())

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.root / kind / f"{name}.json").read_text())

    def cell_names(self) -> list[str]:
        return [w["name"] for w in self.spec["workloads"]]

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.spec["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        workload = self._json("workloads", name)
        traffic = f"{workload['loop']}.{workload['mix']}"
        if entry["traffic"] != traffic:
            raise ValueError(f"{name}: BENCHMARK.json says traffic "
                             f"{entry['traffic']!r}, its file {traffic!r}")
        e2e = [m for m in self.spec["end_to_end"]
               if name in m.get("workloads", [name])]
        mine = {m["name"] for m in e2e}
        layer = [m for m in self.spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in mine)]
        readers = {m["name"]: load_module(
            self.root / "metrics" / f"{m['name']}.py").read
            for m in e2e + layer}
        return Cell(name, self._json("configs", entry["config"]), workload,
                    self._json("mixes", workload["mix"]),
                    load_module(self.root / "traffic"
                                / f"{workload['loop']}.py"),
                    e2e, layer, readers)
