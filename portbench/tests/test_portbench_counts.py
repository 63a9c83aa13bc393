"""The benchmark's frozen kernel counts (``portbench/counts/``) held to the
bring-up gate's (``chip_smoke.py``: ``kernel_bounds``, ``batched_bounds``)
at N = 64, B = 256.  The test imports ``chip_smoke.py``; the harness does
not."""

import ast
from pathlib import Path

import pytest

import chip_smoke
from portbench.counts import k2, k8a, k8b
from portbench.counts._ops import least_s

HERE = Path(__file__).resolve().parents[1]
PEAKS = dict(f32_flops_per_s=chip_smoke.PEAK_F32, bytes_per_s=chip_smoke.PEAK_BYTES)
N, B, NQ = 64, 256, 7


def _ms(work):
    return 1e3 * least_s(*work, PEAKS)


@pytest.mark.parametrize("iters", [0, 17, 166, 167])
def test_k2_matches_the_gate(iters):
    want = chip_smoke.kernel_bounds(N, iters, 0, 1, 10)["K2 pcg_dz_solve"][0]
    assert _ms(k2.work(N, NQ, iters)) == pytest.approx(want, rel=1e-12)


def test_k8a_matches_the_gate():
    want = chip_smoke.batched_bounds(N, B, 1)["K8a build_kkt_schur_batched"][0]
    assert _ms(k8a.work(N, NQ, B)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("steps", [B, 100 * B, 168 * B])
def test_k8b_matches_the_gate(steps):
    want = chip_smoke.batched_bounds(N, B, steps)["K8b pcg_solve_batched"][0]
    assert _ms(k8b.work(N, NQ, B, steps)) == pytest.approx(want, rel=1e-12)


def test_peaks_table_holds_the_gates_peaks():
    import json

    row = json.loads((HERE / "peaks.json").read_text())["H100"]
    assert row["f32_flops_per_s"] == chip_smoke.PEAK_F32
    assert row["bytes_per_s"] == chip_smoke.PEAK_BYTES


def test_harness_reads_nothing_of_the_gate_or_the_old_benchmark():
    """No module of the benchmark but its tests imports chip_smoke, bench,
    benchmarks, the JAX package or JAX."""
    banned = {"chip_smoke", "bench", "benchmarks", "mpcgpu_tpu", "jax", "jaxlib",
              "flax"}
    for f in sorted(HERE.rglob("*.py")):
        if "tests" in f.relative_to(HERE).parts:
            continue
        tree = ast.parse(f.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not {n.split(".")[0] for n in names} & banned, f
            # no path the code opens names them (docstrings may)
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                for word in ("benchmarks/", "bench.py", "chip_smoke"):
                    assert word not in node.value, (f, word)
