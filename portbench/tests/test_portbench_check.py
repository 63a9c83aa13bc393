"""The check that decides ``correct``, shown to fail: the control (the
reference put in the program's place one arithmetic below the
configuration's f32) and each fault a cell can have, planted under a run
that skips the harness's look for a card.  On the CPU at a small size
on the cells' own traffic (the kernels' plain versions), and the control
on the card at the cells' own sizes."""

import argparse
import time

import pytest
import torch

from portbench import check, harness
from portbench.drivers import Step

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SMALL = dict(knots=16, pcg_max_iter=30, warmup_updates=2, check_updates=256,
             check_instances=3, check_block=64)


def _small(cell):
    cfg = dict(SMALL, batch=4) if harness.cell_plan(SPEC, cell)["cfg"]["batch"] > 1 \
        else dict(SMALL)
    return dict(cfg=cfg)


def _run(cell, wrap=None, seconds=3.0):
    torch.set_num_threads(2)
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 11, seconds=seconds, trace=0)
    return harness.run(args, time.perf_counter(), device="cpu",
                       overrides=_small(cell), wrap_driver=wrap)


def unchanged(drv):
    """The solve returns the state it was given."""
    solve = drv.solve
    drv.solve = lambda xu, lam, xs, ee, rho: solve(xu, lam, xs, ee, rho)._replace(
        xu=xu, lam=lam, rho=rho)


def half_batch(drv):
    """The second half of the instances is left out: their plans come back
    as they went in."""
    solve = drv.solve

    def broken(xu, lam, xs, ee, rho):
        out = solve(xu, lam, xs, ee, rho)
        h = xu.shape[0] // 2
        cat = lambda a, b: torch.cat([a[:h], b[h:]])
        return out._replace(xu=cat(out.xu, xu), lam=cat(out.lam, lam),
                            rho=cat(out.rho, rho))
    drv.solve = broken


def altered(drv):
    """One control of the returned plan is altered where it is produced."""
    solve = drv.solve

    def broken(*a):
        out = solve(*a)
        xu = out.xu.clone()
        xu[:, xu.shape[1] // 2, 14] += 1.0
        return out._replace(xu=xu)
    drv.solve = broken


def breakdown(drv):
    """The solve's multipliers come back not finite (a PCG breakdown): the
    state carries them on."""
    solve = drv.solve

    def broken(*a):
        out = solve(*a)
        lam = out.lam.clone()
        lam[0, 0, 0] = float("nan")
        return out._replace(lam=lam)
    drv.solve = broken


def plant_still(drv):
    """The plant step returns the state it was given."""
    drv.plant = lambda xs, *a: xs.clone()


NX = 14  # the IIWA-14's state width


def dz_controls(mp):
    """The dz recovery leaves the controls' step out (K2's tail for one
    arm, K8c for the fleet)."""
    from mpcgpu_tpu_torch.parallel import batched_cuda
    from mpcgpu_tpu_torch.solver import sqp

    def drop(dz):
        dz = dz.clone()
        dz[..., NX:] = 0
        return dz

    solve, recover = sqp.pcg_dz_solve, batched_cuda.compute_dz_batched
    mp.setattr(sqp, "pcg_dz_solve", lambda *a, **k: (
        lambda lam, dz, it, ok: (lam, drop(dz), it, ok))(*solve(*a, **k)))
    mp.setattr(batched_cuda, "compute_dz_batched",
               lambda *a, **k: drop(recover(*a, **k)))


def ls_choice(mp):
    """The line search steps by another length than the one whose merit
    it chose: the candidates' lengths in reverse order."""
    from mpcgpu_tpu_torch.parallel import batched_cuda
    from mpcgpu_tpu_torch.solver import sqp

    update = sqp.line_search_update

    def broken(merits, alphas, *a):
        return update(merits, torch.cat([alphas[..., :1],
                                         alphas[..., 1:].flip(-1)], -1), *a)
    for mod in (sqp, batched_cuda):
        mp.setattr(mod, "line_search_update", broken)


FAULTS = dict(unchanged=unchanged, altered=altered, plant_still=plant_still,
              half_batch=half_batch, breakdown=breakdown)
# faults planted inside the port (by monkeypatch) rather than on its driver
PATCHES = dict(dz_controls=dz_controls, ls_choice=ls_choice)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["plan_lam"]["count"] > 0
    assert out["checks"]["nonfinite"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_makes_the_run_incorrect(cell, fault):
    batched = harness.cell_plan(SPEC, cell)["cfg"]["batch"] > 1
    if fault == "half_batch" and not batched:
        pytest.skip("one instance: no half of a batch to leave out")
    out = _run(cell, FAULTS[fault])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", sorted(PATCHES))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_inside_the_solve_makes_the_run_incorrect(cell, fault, monkeypatch):
    PATCHES[fault](monkeypatch)
    out = _run(cell)
    assert out["correct"] is False, out["checks"]


def _window(cell, seed, dev, seconds, overrides=None):
    plan = harness.cell_plan(SPEC, cell)
    overrides = overrides or {}
    cfg = {**plan["cfg"], **overrides.get("cfg", {})}
    mix = {**plan["mix"], **overrides.get("mix", {})}
    drv = harness.load_module(harness.HERE / "drivers" / f"{cfg['driver']}.py",
                              f"portbench.drivers.{cfg['driver']}").Driver(cfg, dev)
    loop = harness.Loop(torch, cfg, mix, drv, seed, dev)
    sampler = harness.Sampler(cfg["check_updates"], len(loop.sched.shift),
                              cfg["batch"], cfg["check_instances"], seed)
    harness.run_window(torch, loop, seconds, sampler)
    return sampler.kept, cfg, plan["limits"]


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_incorrect(cell, mode):
    torch.set_num_threads(2)
    dev = torch.device("cpu")
    kept, cfg, limits = _window(cell, 5, dev, 3.0, _small(cell))
    assert check.judge(torch, kept, cfg, limits, dev)["correct"] is True
    control = check.Control(mode, dev, cfg)
    assert check.judge(torch, kept, cfg, limits, dev, control)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_incorrect_on_the_card(card, cell):
    """At the cell's own size, on three seeds: the program is correct, the
    TF32 control is not."""
    for seed in (3000000001, 3000000002, 3000000003):
        kept, cfg, limits = _window(cell, seed, card, 8.0)
        assert check.judge(torch, kept, cfg, limits, card)["correct"] is True
        control = check.Control("tf32", card, cfg)
        verdict = check.judge(torch, kept, cfg, limits, card, control)
        assert verdict["correct"] is False, verdict["checks"]
