"""One run of one cell: set-up, the measured window, the traced segment,
the check against the reference, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``: its
configuration file (``configs/<config>.json``: the problem, the driver, the
check's sample sizes), its traffic mix (``traffic/<traffic>.json``, read by
``traffic.py``), the limits of its check (``limits/<cell>.json``) and the
readers of its per-layer metrics (``metrics/<metric>.py``).

The loop is closed: one client, which hands the measured state to the
controller each control period and waits for the plan.  An update's
latency runs from the call into the port's solve to the end of the
``torch.cuda.synchronize()`` after it; the plant's step and the shift of
plan, multipliers and goal window follow outside it and inside the window.
The simulated clock advances one period per update whatever the solve
took, so the work per update is the same on every commit.
"""

from __future__ import annotations

import importlib.util
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "mpcgpu_tpu")


class Refused(Exception):
    """A run that cannot give a result; the message goes to stderr."""

    def __init__(self, code: int, what: str, **detail):
        super().__init__(what)
        self.code, self.detail = code, dict(error=what, **detail)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: what this
    process has loaded), each compared whole: ``mpcgpu_tpu_torch`` is not
    ``mpcgpu_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_plan(spec: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    from portbench import traffic

    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise Refused(2, "unknown workload", workload=workload,
                      known=sorted(cells))
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    applies = lambda m: workload in m.get("workloads", [workload])
    return dict(
        cell=cell, cfg=cfg, mix=traffic.load(cell["traffic"]),
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def card_info(torch) -> dict:
    """The card's name (torch) and power limit (nvidia-smi; None where it
    cannot be read)."""
    info = dict(kind=torch.cuda.get_device_name(0), power_limit_w=None)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def peaks_for(kind: str) -> dict | None:
    table = json.loads((HERE / "peaks.json").read_text())
    for key, row in table.items():
        if key in kind:
            return row
    return None


class Loop:
    """B closed loops on the traffic mix's schedule, every tensor with a
    leading instance axis; ``update()`` runs one control update."""

    def __init__(self, torch, cfg: dict, mix: dict, driver, seed: int, dev):
        from portbench import traffic

        self.torch, self.cfg, self.mix, self.drv, self.dev = torch, cfg, mix, driver, dev
        self.sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
                     else (lambda: None))
        self.N, self.B, self.nq = cfg["knots"], cfg["batch"], cfg["nq"]
        self.nx = 2 * self.nq
        self.period = cfg["simulation_period_us"] * 1e-6
        self.sim_step = cfg["sim_step_s"]
        self.n_sub = int(self.period / self.sim_step)
        self.sched = traffic.schedule(mix, self.N, self.nq, cfg["dt"], self.period,
                                      cfg["shift_threshold_frac"], dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
        self.t_first, self.t_period, self.t_step = f(0.0), f(self.period), f(cfg["dt"])
        self.episodes = 0
        self.reset()

    def reset(self):
        """A new episode: starts drawn from the seed's generator."""
        from portbench import traffic

        torch, s, N, B = self.torch, self.sched, self.N, self.B
        xs = traffic.starts(self.gen, s, B, self.nx, self.mix["start_sigma"])
        self.xu = self.pin(s.xu_rows[:N].expand(B, N, s.xu_rows.shape[1]), xs)
        self.xu_old, self.xs = self.xu, xs
        self.lam = torch.zeros((B, N, self.nx), dtype=torch.float32, device=self.dev)
        self.ee = s.ee_rows[:N].expand(B, N, s.ee_rows.shape[1]).contiguous()
        self.rho = torch.full((B,), self.cfg["rho0"], dtype=torch.float32,
                              device=self.dev)
        self.t_off, self.t_off_s, self.i = self.t_first, 0.0, 0
        self.episodes += 1

    def pin(self, xu, xs):
        """The plan with its first state set to the measured one (a new
        tensor: the old plan still drives the plant)."""
        xu = xu.clone()
        xu[:, 0, :self.nx] = xs
        return xu

    def update(self, rec=None, sample=None):
        """One control update.  ``rec``: lists to append the latency, the
        host time of the solve call and its PCG iterations to; ``sample``:
        a callback that may keep the update's inputs and outputs."""
        torch, s = self.torch, self.sched
        if self.i == len(s.shift):
            self.reset()
        xu, lam, xs, ee, rho = self.xu, self.lam, self.xs, self.ee, self.rho
        t0 = time.perf_counter()
        out = self.drv.solve(xu, lam, xs, ee, rho)
        t1 = time.perf_counter()
        self.sync()
        t2 = time.perf_counter()
        xs_n = self.drv.plant(xs, self.xu_old, self.t_off, self.t_period,
                              self.t_step, self.n_sub, self.sim_step)
        xu_n, lam_n, ee_n = out.xu, out.lam, ee
        if s.shift[self.i]:
            xu_n = torch.cat([xu_n[:, 1:], s.tails[self.i].expand(self.B, 1, -1)], 1)
            lam_n = torch.cat([lam_n[:, 1:], lam_n[:, -1:]], 1)
            ee_n = torch.cat([ee[:, 1:], s.goal_tails[self.i].expand(self.B, 1, -1)], 1)
        if sample is not None:
            sample(dict(xu=xu, lam=lam, xs=xs, ee=ee, rho=rho, out=out,
                        plan_old=self.xu_old, t_off=self.t_off_s, xs_next=xs_n,
                        pos=self.i))
        self.xu, self.lam, self.ee, self.rho = self.pin(xu_n, xs_n), lam_n, ee_n, out.rho
        self.xu_old, self.xs = out.xu, xs_n
        self.t_off, self.t_off_s = self.t_period, self.period
        self.i += 1
        self.sync()
        if rec is not None:
            rec["latency_s"].append(t2 - t0)
            rec["host_s"].append(t1 - t0)
            rec["pcg_iters"].append(out.pcg_iters)


class Sampler:
    """The updates the check compares, drawn from the seed: the episode's
    updates fall into ``k`` strata of consecutive positions, and each
    stratum keeps one of the window's updates at its positions, uniformly
    (a reservoir of one).  Every stretch of the trace is so sampled in
    every run whose window covers an episode, whatever the seed; of each
    kept update, ``instances`` instances drawn from the seed are compared
    (all of them when the batch is no larger)."""

    def __init__(self, k: int, episode: int, batch: int, instances: int,
                 seed: int):
        self.k, self.episode, self.rng = k, episode, random.Random(seed)
        self.batch, self.instances = batch, min(instances, batch)
        self.seen, self.slots = [0] * k, [None] * k

    def __call__(self, item):
        s = item["pos"] * self.k // self.episode
        self.seen[s] += 1
        if self.rng.randrange(self.seen[s]) == 0:
            item["instances"] = sorted(self.rng.sample(range(self.batch),
                                                       self.instances))
            self.slots[s] = item

    @property
    def kept(self) -> list:
        return [x for x in self.slots if x is not None]


def new_rec() -> dict:
    return dict(latency_s=[], host_s=[], pcg_iters=[])


def run_window(torch, loop: Loop, seconds: float, sampler) -> dict:
    """Control updates until ``seconds`` have passed; the window closes at
    the end of the update that passes it."""
    rec = new_rec()
    loop.reset()
    episodes0 = loop.episodes
    t0, cpu0 = time.perf_counter(), time.process_time()
    while True:
        loop.update(rec, sampler)
        if time.perf_counter() - t0 >= seconds:
            break
    rec["window_s"] = time.perf_counter() - t0
    # this process's CPU seconds per second of the window
    rec["cpu_share"] = (time.process_time() - cpu0) / rec["window_s"]
    rec["episodes"] = loop.episodes - episodes0 + 1
    rec["pcg_iters"] = torch.stack(rec["pcg_iters"]).cpu()
    return rec


def run_traced(torch, loop: Loop, updates: int) -> dict:
    """``updates`` more control updates under torch.profiler; the trace
    stays in memory."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    rec = new_rec()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(updates):
                loop.update(rec)
    rec["pcg_iters"] = torch.stack(rec["pcg_iters"]).cpu()
    rec.update(trace.reduce(prof))
    return rec


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(metrics: list, rec: dict, B: int, setup_s: float) -> dict:
    """The cell's end-to-end metrics, each by its name's first part (a
    metric of some cells only is named ``<metric>.<tag>``)."""
    lat = rec["latency_s"]
    value = dict(update_p95_us=percentile(lat, 95) * 1e6,
                 update_p50_us=statistics.median(lat) * 1e6,
                 instance_updates_per_s=B * len(lat) / rec["window_s"],
                 setup_s=setup_s)
    return {m["name"]: dict(value=value[m["name"].split(".")[0]], unit=m["unit"])
            for m in metrics}


def per_layer(metrics: list, rec: dict) -> dict:
    """Each metric's reader (``metrics/<name>.py``: ``read(rec)``, by the
    name's first part, as ``end_to_end`` takes it: ``<metric>.<tag>`` is
    read by ``metrics/<metric>.py``); a reader that finds nothing returns
    None and its metric is left out."""
    out = {}
    for m in metrics:
        base = m["name"].split(".")[0]
        mod = load_module(HERE / "metrics" / f"{base}.py", "portbench_metric_" + base)
        v = mod.read(rec)
        if v is not None:
            out[m["name"]] = dict(value=float(v), unit=m["unit"])
    return out


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def run(args, t_start: float, device=None, overrides=None,
        wrap_driver=None) -> dict:
    """One run; returns the result dict.  For the check's tests only:
    ``device`` runs on a device other than the card without the look for
    one, ``overrides`` ({"cfg": {...}, "mix": {...}}) replaces settings of
    the configuration and the traffic (smaller sizes on the CPU), and
    ``wrap_driver(driver)`` may break the system under test."""
    spec = load_spec()
    plan = cell_plan(spec, args.workload)
    overrides = overrides or {}
    plan["mix"] = {**plan["mix"], **overrides.get("mix", {})}
    cfg, chips = {**plan["cfg"], **overrides.get("cfg", {})}, plan["cell"]["chips"]

    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise Refused(3, "no CUDA device: the benchmark measures the card "
                          "and does not fall back to the CPU")
        if torch.cuda.device_count() < chips:
            raise Refused(3, "too few CUDA devices", needed=chips,
                          found=torch.cuda.device_count())
        dev = torch.device("cuda", 0)
        card = card_info(torch)
    else:
        dev = torch.device(device)
        card = dict(kind=str(dev), power_limit_w=None)
    peaks = peaks_for(card["kind"])
    log(f"portbench: {args.workload} seed {args.seed} on {card['kind']}, power "
        f"limit {card['power_limit_w']} W; peaks divided by: {peaks}")

    drv_mod = load_module(HERE / "drivers" / f"{cfg['driver']}.py",
                          f"portbench.drivers.{cfg['driver']}")
    drv = drv_mod.Driver(cfg, dev)
    if wrap_driver is not None:
        wrap_driver(drv)
    loop = Loop(torch, cfg, plan["mix"], drv, args.seed, dev)
    for _ in range(cfg["warmup_updates"]):
        loop.update()
    loop.reset()
    loop.sync()
    bad = forbidden_modules()
    if bad:
        raise Refused(4, "forbidden modules loaded at the end of set-up", modules=bad)
    setup_s = time.perf_counter() - t_start

    sampler = Sampler(cfg["check_updates"], len(loop.sched.shift), cfg["batch"],
                      cfg["check_instances"], args.seed)
    rec = run_window(torch, loop, args.seconds, sampler)
    if args.trace:
        rec["traced"] = run_traced(torch, loop, cfg["trace_updates"])
    rec.update(cfg=cfg, peaks=peaks)
    memory_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                   else 0)
    bad = forbidden_modules()
    if bad:
        raise Refused(4, "forbidden modules loaded after the window", modules=bad)
    del loop

    from portbench import check

    verdict = check.judge(torch, sampler.kept, cfg, plan["limits"], dev)
    if args.trace:
        metrics = per_layer(plan["per_layer"], rec)
    else:
        metrics = end_to_end(plan["end_to_end"], rec, cfg["batch"], setup_s)
    device_info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                       kind=card["kind"], count=chips,
                       memory_peak_bytes=int(memory_peak))
    result = dict(correct=verdict["correct"],
                  attempted=cfg["batch"] * len(rec["latency_s"]),
                  failed=verdict["failed"], metrics=metrics, device=device_info)
    if args.trace:
        tr = rec["traced"]
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = dict(device_ops=tr["device_ops"],
                                   idle_gaps=tr["idle_gaps"])
    lat = np.sort(np.asarray(rec["latency_s"])) * 1e6
    runs = (rec["pcg_iters"] >= 0).any(1).sum(-1)
    log(f"portbench: {len(lat)} updates in {rec['window_s']:.3f} s over "
        f"{rec['episodes']} episode(s); set-up {setup_s:.3f} s; memory peak "
        f"{memory_peak} bytes; latency us p10/25/50/75/90/99 "
        f"{[round(float(np.percentile(lat, q)), 1) for q in (10, 25, 50, 75, 90, 99)]}; "
        f"updates by SQP iterations {np.bincount(runs.numpy()).tolist()}; CPU "
        f"share {rec['cpu_share']:.3f}")
    for name, c in verdict["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r} over {c['count']} "
            f"compared")
    result["checks"] = verdict["checks"]
    return result
