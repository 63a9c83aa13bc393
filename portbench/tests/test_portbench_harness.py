"""``BENCHMARK.json`` and the files the harness finds by its names, the
look for JAX, and a run without a card (CPU); a traced run of each cell
(card)."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import check, harness

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_spec_has_exactly_the_contracts_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    keys = dict(configs={"name", "source", "file", "reduced", "why"},
                workloads={"name", "config", "traffic", "chips", "why"},
                end_to_end={"name", "unit", "better", "bound", "source"},
                per_layer={"name", "unit", "better", "source", "layer", "moves"})
    for group, allowed in keys.items():
        for entry in SPEC[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert allowed <= set(entry) <= allowed | extra, entry


def test_names_units_and_lines_use_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads", "per_layer"):
                    assert LINE.match(e[key]), e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    plan = harness.cell_plan(SPEC, cell)
    cfg, entry = plan["cfg"], {c["name"]: c for c in SPEC["configs"]}[plan["cell"]["config"]]
    assert entry["file"].startswith("portbench/configs/")
    assert (HERE / "drivers" / f"{cfg['driver']}.py").is_file()
    assert (HERE / "traces" / f"{plan['mix']['trace']}_traj.csv").is_file()
    assert set(plan["limits"]) == set(check.NUMBERS) | {"plan_f32_holds"}
    assert plan["limits"]["nonfinite"] == 0
    e2e = {m["name"] for m in plan["end_to_end"]}
    # the one arm's median is left out: its latencies fall into two modes
    median = {"update_p50_us"} if cfg["batch"] > 1 else set()
    assert {n.split(".")[0] for n in e2e} == {"setup_s", "update_p95_us",
                                             "instance_updates_per_s"} | median
    assert plan["per_layer"], cell
    for m in plan["per_layer"]:
        assert (HERE / "metrics" / f"{m['name'].split('.')[0]}.py").is_file(), m["name"]
        assert m["moves"] in e2e


def test_every_config_is_used_and_every_metric_names_known_cells():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(LINE.match(layer) for layer in layers)


@pytest.mark.parametrize("name", sorted(m["name"] for m in SPEC["per_layer"]))
def test_metric_readers_return_nothing_from_an_empty_record(name):
    base = name.split(".")[0]
    mod = harness.load_module(HERE / "metrics" / f"{base}.py", "m_" + base)
    rec = dict(host_s=[], latency_s=[], pcg_iters=torch.zeros((0, 1, 2)),
               cfg=dict(knots=64, nq=7, batch=1), peaks=None)
    assert mod.read(rec) is None


@pytest.mark.parametrize("name, batch", [("k2_roofline", 1), ("k8b_roofline", 4)])
def test_roofline_readers_take_the_calls_the_trace_holds(name, batch):
    """A trace that dropped one call's record still reads: the mean least
    time over the loop's solves, times the calls the trace holds."""
    from portbench.counts import _ops, k2, k8b

    mod = harness.load_module(HERE / "metrics" / f"{name}.py", "m_" + name)
    kernel, work = ((k2.KERNEL, lambda i: k2.work(64, 7, i)) if batch == 1 else
                    (k8b.KERNEL, lambda i: k8b.work(64, 7, batch, batch * (i + 1))))
    peaks = harness.peaks_for("NVIDIA H100 80GB HBM3")
    iters = torch.full((200, batch, 2), 50, dtype=torch.int32)
    rec = dict(cfg=dict(knots=64, nq=7, batch=batch), peaks=peaks,
               traced=dict(pcg_iters=iters, calls_by_op={kernel: 399},
                           device_s_by_op={kernel: 0.05}))
    want = 100.0 * 399 * _ops.least_s(*work(50), peaks) / 0.05
    assert mod.read(rec) == pytest.approx(want, rel=1e-12)


def test_the_module_check_compares_whole_top_level_names():
    f = harness.forbidden_modules
    assert f(["jax", "numpy"]) == ["jax"]
    assert f(["jaxlib.xla_client"]) == ["jaxlib"]
    assert f(["mpcgpu_tpu.solver.sqp", "mpcgpu_tpu"]) == ["mpcgpu_tpu"]
    assert f(["flax.linen"]) == ["flax"]
    assert f(["mpcgpu_tpu_torch", "mpcgpu_tpu_torch.solver.sqp", "jaxtyping",
              "portbench.harness"]) == []


def _run(cwd, env_extra, seconds="1"):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           CELLS[0], "--seed", "3000000000", "--seconds", seconds,
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_a_run_without_a_card_is_refused_with_a_structured_line():
    r = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    err = json.loads(r.stderr.strip().splitlines()[-1])
    assert "no CUDA device" in err["error"]


def test_a_run_beside_no_program_is_refused(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    r = _run(tmp_path, {})
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_card(card, cell):
    """A traced run at the benchmark's own window: a shorter one may sample
    too few updates that f32 holds for ``plan_lam``'s quartile."""
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                        "--seed", "4000000001", "--seconds", str(SPEC["run_seconds"]),
                        "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    want = {m["name"] for m in harness.cell_plan(SPEC, cell)["per_layer"]}
    assert set(out["metrics"]) == want
