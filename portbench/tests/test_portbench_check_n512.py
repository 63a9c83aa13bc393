"""The check of ``arm512-calm`` shown to fail under each planted fault, on
the CPU at a small size, sampled densely.

``test_portbench_check.py`` runs every cell for 3 s on the CPU and samples
256 strata of an episode.  An episode of ``arm512-calm``'s traffic is 5079
updates long, of which such a window reaches the first ~30, so its strata
hold two sampled updates there, and the line search's planted fault
(``ls_choice``) can hide in them.  Here the same runs take one stratum per
position of the episode, so every update the window reaches is sampled."""

import argparse
import time

import pytest
import torch

from portbench import harness, traffic
from portbench.tests import test_portbench_check as base

CELL = "arm512-calm"


def _run(wrap=None):
    torch.set_num_threads(2)
    plan = harness.cell_plan(base.SPEC, CELL)
    cfg = plan["cfg"]
    episode = len(traffic.schedule(plan["mix"], base.SMALL["knots"], cfg["nq"],
                                   cfg["dt"], cfg["simulation_period_us"] * 1e-6,
                                   cfg["shift_threshold_frac"], "cpu").shift)
    overrides = dict(cfg=dict(base.SMALL, check_updates=episode))
    args = argparse.Namespace(workload=CELL, seed=2 ** 31 + 11, seconds=3.0, trace=0)
    return harness.run(args, time.perf_counter(), device="cpu", overrides=overrides,
                       wrap_driver=wrap)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["plan_lam"]["count"] >= 10


@pytest.mark.parametrize("fault", sorted(set(base.FAULTS) - {"half_batch"}))
def test_a_fault_makes_the_run_incorrect(fault):
    out = _run(base.FAULTS[fault])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", sorted(base.PATCHES))
def test_a_fault_inside_the_solve_makes_the_run_incorrect(fault, monkeypatch):
    base.PATCHES[fault](monkeypatch)
    out = _run()
    assert out["correct"] is False, out["checks"]
