"""The check that decides ``correct``: the updates the window sampled,
worked out again by the reference (``reference/update.py``) in f64 from
the inputs the harness handed to the program, after the window.

Every sampled instance-update counts in ``nonfinite``; the plan's numbers
are compared over the updates that f32 can hold; ``plant_state`` over all:

  * ``nonfinite``: the sampled instance-updates whose inputs (the plan,
    multipliers, state and rho carried from the update before) or outputs
    (plan, multipliers, rho, merit, the plant's next state) hold a number
    that is not finite.  A plan that is not finite is a wrong answer,
    whatever caused it, and the state it leaves carries it on; the limit
    is 0;
  * ``plan_lam``: max |lam - lam_ref| / max |lam_ref|, the multipliers the
    solve returned: KKT and Schur (K1 / K8a), PCG (K2 / K8b);
  * ``plan_step``: max |dxu - dxu_ref| / max |dxu_ref|, the step the solve
    took from the plan it was given (dxu = xu returned - xu given): the dz
    recovery (K2's tail / K8c) and the line search's choice (K3 / K3b);
  * ``plan_rho``: |rho - rho_ref| / rho_ref, the regularization the solve
    hands on: the line search's verdicts and the rho schedule;
  * ``plan_merit``: |m - m_ref| / m_ref, the merit the solve reported
    against the reference's merit of its own chosen plan (K3 / K3b);
  * ``plant_state``: max |x - x_ref| / max |x_ref|, the measured state the
    plant step (K4 / K4b) returned against the reference's from the same
    state and plan.

The plan's numbers are taken over the updates whose answer f32 can hold,
by a rule on the reference alone: the reference computed in f32 from the
same inputs makes the same line-search choice in every SQP iteration as
in f64 and departs from its f64 multipliers by at most
``plan_f32_holds`` (the limits file).  Elsewhere (a Schur system's
condition number reaches ~1e13 on a recorded trace's runaway rows) no f32
computation of the update, the reference's own included, keeps a digit
of lam or a line search's verdict.  A non-finite error counts as
infinite.

Each of those numbers is the upper quartile of its errors, not the
largest: on updates that f32 holds a few still part ways chaotically
(cond ~1e6-1e8); a fault that touches a quarter of the updates or more
shows, and one that makes a number not finite shows in ``nonfinite``.

``correct`` holds when every number is at most its limit
(``limits/<cell>.json``) and the plan's numbers compared at least one
update.  ``readings`` also gives, per sampled instance-update, its
position in the episode (``pos``), the reference's f32 departure
(``lam_f32``), whether f32 holds it (``holds``) and the answer's lam
error whatever that departure (``lam_all``).
"""

from __future__ import annotations

from portbench.reference.arith import Arith
from portbench.reference.dynamics import Chain
from portbench.reference.update import Settings, merit, plant, sqp_solve


def settings(cfg: dict) -> Settings:
    return Settings(dt=cfg["dt"], qd_cost=cfg["qd_cost"], r_cost=cfg["r_cost"],
                    mu=cfg["mu"], num_alphas=cfg["num_alphas"],
                    sqp_max_iter=cfg["sqp_max_iter"],
                    pcg_max_iter=cfg["pcg_max_iter"],
                    exit_tol=cfg["pcg_exit_tol"], rho_min=cfg["rho_min"],
                    rho_factor=cfg["rho_factor"], rho_max=cfg["rho_max"],
                    rho_reset=cfg["rho_reset"])


def _rel(a, b):
    """max |a - b| / max |b| per instance (leading axis)."""
    dims = tuple(range(1, a.dim()))
    return (a - b).abs().amax(dims) / b.abs().amax(dims).clamp_min(1e-30)


class Control:
    """The reference computed in ``mode`` (``reference/arith.py``),
    answering the sampled updates in the program's place: the control of
    the check, which has to come out as not correct."""

    def __init__(self, mode: str, dev, cfg: dict):
        self.ch, self.st, self.cfg = Chain(Arith(mode), dev), settings(cfg), cfg

    def answers(self, xu, lam, xs, ee, rho, t_off: float, plan_old):
        d = self.ch.ar.dtype
        p = sqp_solve(self.ch, self.st, xu.to(d), lam.to(d), xs.to(d), ee.to(d),
                      rho.to(d))
        x = _plant(self.ch, self.st, self.cfg, xs.to(d), plan_old.to(d), t_off)
        return [t.double() for t in (p.xu, p.lam, p.rho, p.merit, x)]


def _plant(ch, st, cfg: dict, xs, plan, t_off: float):
    period = cfg["simulation_period_us"] * 1e-6
    return plant(ch, st, xs, plan, t_off, period,
                 int(period / cfg["sim_step_s"]), cfg["sim_step_s"])


def _finite(*ts):
    """Per instance: every number of every tensor finite."""
    ok = None
    for t in ts:
        f = t.isfinite().flatten(1).all(1) if t.dim() > 1 else t.isfinite()
        ok = f if ok is None else ok & f
    return ok


def readings(torch, samples: list, cfg: dict, holds: float, dev,
             control=None) -> dict:
    """Each number's per-instance readings over the sampled updates, f64
    tensors on the CPU (``nonfinite``: 1 or 0 per sampled instance-update).
    The program's answers are the sampled outputs; a ``Control`` answers
    in their place when given."""
    ref, ref32 = Chain(Arith("f64"), dev), Chain(Arith("f32"), dev)
    st = settings(cfg)
    f64 = lambda t: t.to(device=dev, dtype=torch.float64)
    out = {k: [] for k in NUMBERS + ("pos", "lam_f32", "lam_all", "holds")}
    # instance-updates grouped by the plant's time offset (0 at an
    # episode's first update), in blocks of check_block
    flat = sorted(((s["t_off"], k, b) for k, s in enumerate(samples)
                   for b in s["instances"]))
    block = cfg["check_block"]
    for i in range(0, len(flat), block):
        part = [(t, k, b) for t, k, b in flat[i:i + block] if t == flat[i][0]]
        rest = [(t, k, b) for t, k, b in flat[i:i + block] if t != flat[i][0]]
        for group in (part, rest):
            if not group:
                continue
            t_off = group[0][0]
            take = lambda key: torch.stack([f64(samples[k][key][b])
                                            for _, k, b in group])
            xu, lam, xs, ee, rho, plan_old = (
                take(key) for key in ("xu", "lam", "xs", "ee", "rho", "plan_old"))
            with torch.no_grad():
                if control is None:
                    got = [torch.stack([f64(getattr(samples[k]["out"], f)[b])
                                        for _, k, b in group])
                           for f in ("xu", "lam", "rho", "merit")] + [take("xs_next")]
                else:
                    got = control.answers(xu, lam, xs, ee, rho, t_off, plan_old)
                sane = _finite(xu, lam, xs, rho, *got)
                out["nonfinite"].append((~sane).double().cpu())
                want = sqp_solve(ref, st, xu, lam, xs, ee, rho)
                f32 = lambda t: t.float()
                near = sqp_solve(ref32, st, f32(xu), f32(lam), f32(xs), f32(ee),
                                 f32(rho))
                drift = _rel(near.lam.double(), want.lam)
                held = (_finite(want.xu, want.lam, want.merit) & (drift <= holds)
                        & (near.alpha_idx == want.alpha_idx).all(1))
                err = _rel(got[1], want.lam).nan_to_num(nan=float("inf"))
                out["plan_lam"].append(err[held].cpu())
                step = _rel(got[0] - xu, want.xu - xu)
                out["plan_step"].append(step[held].cpu())
                out["plan_rho"].append(((got[2] - want.rho).abs()
                                        / want.rho.abs())[held].cpu())
                out["plan_merit"].append(((got[3] - want.merit).abs()
                                          / want.merit.abs())[held].cpu())
                x_ref = _plant(ref, st, cfg, xs, plan_old, t_off)
                out["plant_state"].append(_rel(got[4], x_ref).cpu())
                out["lam_all"].append(err.cpu())
                out["lam_f32"].append(drift.cpu())
                out["holds"].append(held.cpu())
                out["pos"].append(torch.tensor([samples[k]["pos"] for _, k, _ in group],
                                               dtype=torch.float64))
    cat = lambda v: (torch.cat(v) if v else torch.zeros(0, dtype=torch.float64))
    return {k: cat(v).nan_to_num(nan=float("inf")) if k in NUMBERS else cat(v)
            for k, v in out.items()}


NUMBERS = ("nonfinite", "plan_lam", "plan_step", "plan_rho", "plan_merit",
           "plant_state")


def statistic(vals, name: str = "") -> float:
    """``nonfinite``: the count; otherwise the upper quartile of a number's
    errors (the lower of the two nearest where it falls between them), 0
    for none."""
    if name == "nonfinite":
        return float(vals.sum())
    if not len(vals):
        return 0.0
    return float(vals.sort().values[(3 * (len(vals) - 1)) // 4])


def judge(torch, samples: list, cfg: dict, limits: dict, dev,
          control=None) -> dict:
    r = readings(torch, samples, cfg, limits["plan_f32_holds"], dev, control)
    checks = {name: dict(value=statistic(r[name], name), limit=limits[name],
                         count=len(r[name])) for name in NUMBERS}
    broken = [n for n, c in checks.items() if not c["value"] <= c["limit"]]
    correct = not broken and checks["plan_lam"]["count"] > 0
    # the compared instance-updates over the limit of a number that broke it
    failed = sum(int((r[n] > limits[n]).sum()) for n in broken)
    return dict(correct=correct, failed=failed, checks=checks)
