"""The benchmark's harness on the CPU: BENCHMARK.json against its contract,
every file found by name, a throwaway entry picked up without an edit,
tiny runs of the cells through the port's CPU path, the faults that have
to turn ``correct`` false, the lower-precision control, and the import
guard."""
import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fnsbench import bench, control, harness
from fnsbench.tests.tiny import tiny_cell

ROOT = bench.HERE.parent
SPEC = json.loads(bench.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**33 + 11


def quiet(*a, **k):
    pass


@pytest.fixture(autouse=True)
def no_guard_in_a_shared_worker(monkeypatch):
    """A test worker may already hold JAX and the JAX package from other
    test files, so in-process runs skip the import guard; a fresh
    process checks it (``test_a_run_loads_neither_jax_nor_the_jax_package``)."""
    monkeypatch.setattr(harness, "guard", lambda when: None)


def run_tiny(cell, seconds=1.5, trace=False):
    return harness.run_cell(cell, SEED, seconds, trace, "cpu",
                            harness.CLOCK(), quiet)


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["fnsbench"] and SPEC["command"][1] == \
        "fnsbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and one_line(c["why"])
        assert c["file"] == f"fnsbench/configs/{c['name']}.json"
        names.add(c["name"])
    used = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names and one_line(w["why"])
        used.add(w["config"])
    assert used == names and cells <= 24
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) \
        == cells
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    every = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + \
        SPEC["per_layer"]
    for entry in every:
        assert NAME.match(entry["name"]), entry["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({e["name"] for e in every}) == len(every)
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("name", bench.Bench().cell_names())
def test_every_cell_loads_by_name(name):
    cell = bench.Bench().cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert set(cell.readers) == e2e | {m["name"] for m in cell.per_layer}
    assert all(m["moves"] in e2e for m in cell.per_layer)
    assert callable(cell.loop.run) and cell.loop.buckets(cell.workload)


def test_a_throwaway_entry_is_found_without_an_edit(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_S", 0.3)
    root = tmp_path / "fnsbench"
    shutil.copytree(bench.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    (root / "configs" / "tiny-rag.json").write_text(json.dumps(
        json.loads((root / "configs" / "rag-576.json").read_text())))
    mix = {"components": [{"kind": "codes", "share": 1.0, "prefix": "u",
                           "widths": [[1]]}]}
    (root / "mixes" / "one_code.json").write_text(json.dumps(mix))
    wl = json.loads((root / "workloads" / "rag-closed-mixed.json")
                    .read_text())
    wl["mix"] = "one_code"
    (root / "workloads" / "tiny-rag-one.json").write_text(json.dumps(wl))
    (root / "metrics" / "answered.closed.py").write_text(
        "def read(rec):\n    return float((rec.done == rec.done).sum())\n")
    spec["configs"].append({"name": "tiny-rag", "source": "x",
                            "file": "fnsbench/configs/tiny-rag.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny-rag-one", "config": "tiny-rag",
                              "traffic": "closed.one_code", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "answered.closed", "unit": "queries",
                              "better": "higher", "source": "host_clock",
                              "layer": "serving front end", "moves": "qps"})
    spec["end_to_end"][1]["workloads"].append("tiny-rag-one")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = bench.Bench(root, tmp_path / "BENCHMARK.json").cell("tiny-rag-one")
    assert "answered.closed" in cell.readers
    tiny = tiny_cell("rag-closed-mixed")
    cell.config["recipe"] = tiny.config["recipe"]
    cell.workload.update({k: tiny.workload[k]
                          for k in ("pool", "clients", "serve")})
    out = run_tiny(cell, trace=True)
    assert out["correct"]
    assert out["metrics"]["answered.closed"]["value"] == out["attempted"]


@pytest.mark.parametrize("name", bench.Bench().cell_names())
def test_a_tiny_run_of_each_cell_is_correct(name):
    out = run_tiny(tiny_cell(name, rate=8.0))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    m = out["metrics"]
    assert m["setup_s"]["value"] > 0
    assert 0.5 < m["recall_at_10"]["value"] <= 1.0
    assert ("qps" in m) != ("latency_p95_ms" in m)


def test_a_traced_tiny_run_reads_its_host_metrics(monkeypatch):
    # the host metrics come from the untraced part of the window
    monkeypatch.setattr(harness, "TRACE_S", 0.3)
    out = run_tiny(tiny_cell("hm-open-mixed", rate=8.0), seconds=2.5,
                   trace=True)
    m = out["metrics"]
    assert m["batch_size.open"]["value"] >= 1
    assert m["queue_wait_ms.open"]["value"] >= 0
    assert m["dispatch_ms.open"]["value"] > 0
    # no device on the CPU: the device readers find nothing and stay out
    assert "device_idle_pct.open" not in m and "breakdown" not in out


def unchanged_walk(vectors, adjacency, pass_bm, q_vecs, seeds, res_v, res_i,
                   p):
    zeros = torch.zeros(q_vecs.shape[0], dtype=torch.int64)
    return {"res_v": res_v, "res_i": res_i, "hops": zeros, "syncs": 0}


def half_batch(fetch):
    def fetch_half(out, q_n):
        ids, stats = fetch(out, q_n)
        return ids[:q_n // 2] + [i[:0] for i in ids[q_n // 2:]], stats
    return fetch_half


def altered_answer(fetch):
    def fetch_altered(out, q_n):
        ids, stats = fetch(out, q_n)
        return [np.r_[ids[(j + 1) % len(ids)][:1], i[1:]]
                for j, i in enumerate(ids)], stats
    return fetch_altered


@pytest.mark.parametrize("name", bench.Bench().cell_names())
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(fault, name, monkeypatch):
    from repro_torch.core.batched import engine
    from repro_torch.kernels import ops
    if fault == "state_unchanged":
        monkeypatch.setattr(ops, "walk_round", unchanged_walk)
    elif fault == "half_batch":
        monkeypatch.setattr(engine, "fetch_results",
                            half_batch(engine.fetch_results))
    else:
        monkeypatch.setattr(engine, "fetch_results",
                            altered_answer(engine.fetch_results))
    out = run_tiny(tiny_cell(name))
    assert not out["correct"], out["checks"]


def test_the_tf32_control_is_not_correct():
    cell = tiny_cell("hm-closed-mixed", pool=256)
    cell.config["recipe"]["n"] = 2000
    out = control.control(cell, SEED, "cpu")
    assert not out["correct"]
    gap = out["checks"]["order_gap"]
    assert gap["value"] > gap["limit"]
    assert all(out["checks"][k]["value"] == 0
               for k in ("unanswered", "bad_ids", "short_answers"))


def test_the_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.serve", "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "repro.core", "flax", "numpy"]) == ["flax", "jax",
                                                         "repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from fnsbench import harness\n"
            "from fnsbench.tests.tiny import tiny_cell\n"
            "harness.run_cell(tiny_cell('rag-closed-mixed'), 3, 1.0, False,"
            " 'cpu', harness.CLOCK(), lambda *a, **k: None)\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    out = subprocess.run([sys.executable, "fnsbench/run.py", "--workload",
                          "hm-closed-mixed", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""

