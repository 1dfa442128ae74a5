"""The harness: discovery by name, BENCHMARK.json's shape, the result
line, and the runs that must print no result."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from calib_bench import harness
from calib_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["calib_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for item in SPEC["configs"] + SPEC["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in names
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_discovery_by_name(cell):
    """Every file a cell needs is found from the names in BENCHMARK.json,
    and each cell reports setup_s, another end-to-end metric and a
    per-layer metric."""
    work = harness.find(SPEC["workloads"], cell, "workload")
    cfg = harness.find(SPEC["configs"], work["config"], "configuration")
    assert (harness.ROOT / cfg["file"]).is_file()
    assert json.loads((harness.ROOT / cfg["file"]).read_text())["name"] \
        == cfg["name"]
    mix = json.loads((harness.BENCH / "traffic"
                      / f"{work['traffic']}.json").read_text())
    assert (harness.BENCH / "units" / f"{mix['unit']}.py").is_file()
    limits = json.loads((harness.BENCH / "limits" / f"{cell}.json")
                        .read_text())
    assert limits and all(v > 0 for v in limits.values())
    e2e, layer = harness.metric_names(SPEC, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert callable(harness.load_file_module(
            harness.BENCH / "metrics" / f"{m['name']}.py").read)


@pytest.mark.parametrize("kernel", ["window_apply_j", "window_apply_jtw",
                                    "window_block_diag"])
def test_work_counts_found(kernel):
    nbytes, flops = harness.Run.work(kernel)(n=1000, gh=8, gw=10, k=2)
    assert nbytes > 1000 * 64 * 4 and flops > 0


def test_result_line_schema():
    result, lines = tiny.run("cg1080.ba_final")
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["correct"] is True and result["attempted"] >= 1
    assert set(result["metrics"]) == {"ba_solve_s", "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and UNIT.match(m["unit"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(result["device"])
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"]
        assert any(line.startswith(f"check {name}:") for line in lines)
    json.dumps(result)


def test_traced_run_on_the_cpu_reports_no_device_metric():
    """Without a card the readers of the device's trace find nothing to
    read, and the counters' metrics still come."""
    result, _ = tiny.run("cg1080.ba_final", trace=True)
    assert "device_idle.ba" not in result["metrics"]
    assert "roofline.window" not in result["metrics"]
    assert result["metrics"]["lm_iters_per_solve"]["value"] >= 1


def test_no_card_no_result(tmp_path):
    """Without a card the command exits with another code than 0 and
    prints no result."""
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_bare_checkout_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and calib_bench/ the
    command exits with another code than 0 and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "calib_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "calib_bench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout
