"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests."""
from __future__ import annotations

import copy

from fnsbench import bench

TINY_RECIPE = {"n": 1500, "d": 256, "n_components": 16, "noise_scale": 0.5}
TINY_WORKLOAD = {"pool": 96}
TINY_SERVE = {"queue_max_batch": 32}


def tiny_cell(name: str, **workload) -> bench.Cell:
    """Cell ``name`` as ``BENCHMARK.json`` has it, at a tiny scale: the
    corpus, the pool, the largest batch and the offered load cut down."""
    cell = bench.Bench().cell(name)
    cell.config, cell.workload, cell.mix = copy.deepcopy(
        (cell.config, cell.workload, cell.mix))
    rc = cell.config["recipe"]
    rc.update(TINY_RECIPE)
    rc["correlated_fields"] = min(rc["correlated_fields"], 6)
    for comp in cell.mix["components"]:
        if comp["kind"] == "conj":
            comp["n_fields"] = rc["correlated_fields"]
    wl = cell.workload
    wl.update(TINY_WORKLOAD)
    wl["serve"].update(TINY_SERVE)
    if "clients" in wl:
        wl["clients"] = 64
    if "rate" in wl:
        wl["rate"] = 60.0
    wl.update(workload)
    return cell
