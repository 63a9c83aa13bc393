"""Every public function and method of the JAX package has its counterpart
in the port, with the JAX parameters; and every C entry point's ctypes
argument table matches its signature in ``csrc/``.

Both trees are read with ``ast``; neither package is imported.  A JAX
function's counterpart is the port's function of the same module path and
name, or the one ``RENAMED`` names (the Pallas wrappers, whose kernels are
CUDA kernels in the port, and the TPU-named helpers).  A same-name
counterpart takes every JAX parameter; a renamed one, whose positional
arguments differ by layout (TPU lanes against rows), takes every JAX
parameter that has a default.  Where both give a literal default, the
defaults agree.  What the port leaves out is listed below with its reason,
as ROADMAP.md's "Not to port" lists it.
"""

import ast
import copy
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "mpcgpu_tpu", ROOT / "mpcgpu_tpu_torch"

# JAX (module, name) -> the port's (module, name)
RENAMED = {
    ("config.py", "PCGConfig.tuned_max_iter_tpu"):
        ("config.py", "PCGConfig.tuned_max_iter_h100"),
    ("models/robot.py", "RobotModel.astype"): ("models/robot.py", "RobotModel.to"),
    ("ops/pcg_pallas.py", "pcg_dz_solve_pallas_lanes"): ("ops/pcg_cuda.py", "pcg_dz_solve"),
    ("ops/pcg_pallas.py", "pcg_solve_pallas"): ("ops/pcg_cuda.py", "pcg_solve_cuda"),
    ("ops/pcg_pallas.py", "pcg_solve_pallas_lanes"): ("ops/pcg_cuda.py", "pcg_solve_cuda"),
    ("ops/pcg_pallas.py", "pcg_slab_step_pallas"):
        ("ops/pcg_slab_cuda.py", "pcg_slab_step_cuda"),
    ("ops/pcg_pallas.py", "pcg_ca_basis_pallas"): ("ops/pcg_ca_cuda.py", "ca_basis_cuda"),
    ("ops/pcr_pallas.py", "pcr_solve_pallas"): ("ops/pcr_cuda.py", "pcr_solve_cuda"),
    ("ops/pcr_pallas.py", "pcr_solve_pallas_lanes"): ("ops/pcr_cuda.py", "pcr_solve_cuda"),
    ("parallel/batched_fused.py", "build_kkt_schur_batched"):
        ("parallel/batched_cuda.py", "build_kkt_schur_batched"),
    ("parallel/batched_fused.py", "pcg_solve_batched_lanes"):
        ("parallel/batched_cuda.py", "pcg_solve_batched"),
    ("parallel/batched_fused.py", "compute_dz_batched"):
        ("parallel/batched_cuda.py", "compute_dz_batched"),
    ("parallel/batched_fused.py", "sqp_solve_batched_fused"):
        ("parallel/batched_cuda.py", "sqp_solve_batched_fused"),
    ("parallel/batched_fused.py", "make_batched_fused_solver"):
        ("parallel/batched_cuda.py", "make_batched_fused_solver"),
    ("parallel/batched_fused.py", "sqp_solve_batched_fused_sharded"):
        ("parallel/batched_cuda.py", "sqp_solve_batched_fused_sharded"),
    ("sim/plant_pallas.py", "simulate_plant_pallas"): ("sim/plant_cuda.py", "simulate_plant"),
    ("solver/kkt_pallas.py", "build_kkt_pallas"): ("solver/kkt_cuda.py", "build_kkt_cuda"),
    ("solver/kkt_pallas.py", "build_kkt_schur_pallas"):
        ("solver/kkt_cuda.py", "build_kkt_schur"),
    ("solver/kkt_pallas.py", "build_kkt_schur_pallas_slab"):
        ("solver/kkt_cuda.py", "build_kkt_schur_slab"),
    ("solver/kkt_pallas.py", "compute_dz_pallas"): ("ops/pcg_cuda.py", "compute_dz_cuda"),
    ("solver/kkt_pallas.py", "compute_dz_pallas_slab"): ("ops/pcg_cuda.py", "compute_dz_slab"),
    ("solver/merit_pallas.py", "line_search_merits_pallas"):
        ("solver/merit_cuda.py", "line_search_merits_fused"),
    ("solver/merit_pallas.py", "line_search_merit_partials_slab"):
        ("solver/merit_cuda.py", "line_search_merit_partials_slab"),
}

# JAX modules with no counterpart
NOT_PORTED_MODULES = {
    "precision.py": "highest-precision f32 contractions on the TPU; the port "
                    "turns TF32 off once, in mpcgpu_tpu_torch/__init__.py",
    "utils/mosaic.py": "the Mosaic compiler's VMEM limit",
    "utils/occupancy.py": "a VMEM fit check that falls back to the XLA twins; "
                          "the port's launch plans refuse a shape, with no fallback",
}
# JAX functions with no counterpart
NOT_PORTED = {
    ("parallel/batched_fused.py", "instances_per_program"):
        "instances packed on the TPU's 128 lanes",
    ("parallel/batched_fused.py", "pack_lanes"): "instances packed on TPU lanes",
    ("parallel/batched_fused.py", "unpack_lanes"): "instances packed on TPU lanes",
    ("solver/kkt_pallas.py", "dz_from_lane_values"):
        "dz on lane-layout values inside a Pallas kernel; the port's is "
        "compute_dz_plain and the dz kernels of csrc/pcg_dz.cu",
    ("solver/kkt_pallas.py", "dz_lane_masks"):
        "iota masks of the lane layout; the port's kernels index knots",
}
# JAX parameters no counterpart takes
EXEMPT_PARAMS = {
    "interpret": "Pallas interpret mode on a CPU: a port wrapper runs its "
                 "plain version for CPU tensors",
    "donate": "XLA buffer donation; PyTorch has none",
    "unroll": "the unrolling of a Pallas loop; the CUDA kernels fix theirs",
    "inst_per_prog": "instances packed on TPU lanes per program",
    "_debug_stage": "a Mosaic compile bisection switch",
    "knots": "the knot count of packed lanes; the port's tensors carry it "
             "in their shape",
    "devices": "one JAX controller drives several chips; a PyTorch process "
               "drives one card (the process group and make_host_aligned_mesh)",
    "axis_name": "a named mesh axis of shard_map; the port's mesh object "
                 "sends and sums itself",
    "x_eval_ext": "K9a forms the terminal cost's state from "
                  "cost.terminal_at_last_state in the kernel",
}
# literal defaults that differ on purpose: (module, name, parameter)
OTHER_DEFAULTS = {
    ("sim/mpc.py", "simulate_mpc", "linsys"):
        '"auto" is the kernels\' "pcg_cuda" on the card and the plain "pcg" '
        "on the CPU, as the JAX package's \"pcg\" is its XLA path on any device",
    ("utils/profiling.py", "trace", "logdir"):
        "None is the temporary directory's mpcgpu_tpu_torch_trace: the port "
        "writes nothing at a fixed path",
}


def _public(pkg: Path) -> dict:
    """{module path: {name or Class.method: FunctionDef}} of the public
    top-level functions and public classes' public methods."""
    out = {}
    for path in sorted(pkg.rglob("*.py")):
        defs = out.setdefault(path.relative_to(pkg).as_posix(), {})
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
                defs[node.name] = node
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) and not sub.name.startswith("_"):
                        defs[f"{node.name}.{sub.name}"] = sub
    return out


JAX_DEFS, PORT_DEFS = _public(JAX), _public(PORT)


def _params(fn: ast.FunctionDef) -> dict:
    """{parameter: default node or None}, the receiver left out."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = dict(zip((p.arg for p in pos), defaults))
    out.update(zip((p.arg for p in a.kwonlyargs), a.kw_defaults))
    for star in (a.vararg, a.kwarg):
        if star is not None:
            out[star.arg] = None
    out.pop("self", None)
    out.pop("cls", None)
    return out


def _literal(node):
    try:
        return True, ast.literal_eval(node)
    except ValueError:
        return False, None


def _gaps(module: str, port_defs: dict = PORT_DEFS) -> list:
    gaps = []
    for name, fn in JAX_DEFS[module].items():
        if (module, name) in NOT_PORTED:
            continue
        renamed = (module, name) in RENAMED
        pmod, pname = RENAMED.get((module, name), (module, name))
        port = port_defs.get(pmod, {}).get(pname)
        if port is None:
            gaps.append(f"{name}: no {pmod}::{pname} in the port")
            continue
        want, have = _params(fn), _params(port)
        for p, default in want.items():
            if p in EXEMPT_PARAMS or (renamed and default is None):
                continue
            if p not in have:
                gaps.append(f"{name}: {pmod}::{pname} lacks {p}")
                continue
            if default is None:
                continue
            if have[p] is None:
                gaps.append(f"{name}: {pmod}::{pname}'s {p} has no default")
                continue
            (ok_j, dj), (ok_p, dp) = _literal(default), _literal(have[p])
            if ok_j and ok_p and dj != dp and (module, name, p) not in OTHER_DEFAULTS:
                gaps.append(f"{name}: {pmod}::{pname}'s {p} defaults to {dp!r}, "
                            f"the JAX package's to {dj!r}")
    return gaps


@pytest.mark.parametrize("module", sorted(JAX_DEFS))
def test_every_public_jax_signature_has_its_counterpart(module):
    if module in NOT_PORTED_MODULES:
        assert module not in PORT_DEFS, f"{module} is ported: drop it from NOT_PORTED_MODULES"
        return
    gaps = _gaps(module)
    assert not gaps, "\n".join(gaps)


def test_the_exemptions_name_what_the_jax_package_has():
    """No exemption is stale: each names a JAX module, function or
    parameter that exists, a left-out function is absent from the port,
    and each renamed counterpart exists."""
    jax_params = {p for defs in JAX_DEFS.values() for fn in defs.values()
                  for p in _params(fn)}
    assert set(EXEMPT_PARAMS) <= jax_params, set(EXEMPT_PARAMS) - jax_params
    for module in NOT_PORTED_MODULES:
        assert module in JAX_DEFS, module
    for (module, name) in NOT_PORTED:
        assert name in JAX_DEFS[module], (module, name)
        assert name not in PORT_DEFS.get(module, {}), f"{name} is ported"
    for (module, name), (pmod, pname) in RENAMED.items():
        assert name in JAX_DEFS[module], (module, name)
        assert pname in PORT_DEFS[pmod], (pmod, pname)
    for (module, name, p) in OTHER_DEFAULTS:
        assert p in _params(JAX_DEFS[module][name]), (module, name, p)
    reasons = (list(NOT_PORTED_MODULES.values()) + list(NOT_PORTED.values())
               + list(EXEMPT_PARAMS.values()) + list(OTHER_DEFAULTS.values()))
    assert all(r.strip() for r in reasons)


def test_the_gap_check_sees_a_missing_keyword():
    """The check itself: the port's K3 wrapper without one of the JAX
    keywords is a gap."""
    module, name = "solver/merit_pallas.py", "line_search_merits_pallas"
    pmod, pname = RENAMED[(module, name)]
    fn = copy.deepcopy(PORT_DEFS[pmod][pname])
    args = fn.args
    i = [a.arg for a in args.args].index("include_zero")
    del args.defaults[i - (len(args.args) - len(args.defaults))]
    del args.args[i]
    port_defs = {**PORT_DEFS, pmod: {**PORT_DEFS[pmod], pname: fn}}
    assert _gaps(module) == []
    assert _gaps(module, port_defs) == [f"{name}: {pmod}::{pname} lacks include_zero"]


# ---- the ctypes argument tables against the C entry points -----------------

_CTYPE = {"P": "c_void_p", "I": "c_int", "F": "c_float"}


def _c_entries(source: str) -> dict:
    """{name: [P / I / F per parameter]} of every extern "C" function."""
    text = re.sub(r"//[^\n]*", "", (PORT / "csrc" / source).read_text())
    out = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        kinds = []
        for arg in (a.strip() for a in args.split(",") if a.strip()):
            kinds.append("P" if "*" in arg else
                         "I" if re.match(r"(const )?int\b", arg) else
                         "F" if re.match(r"(const )?float\b", arg) else arg)
        out[name] = kinds
    return out


def _table() -> dict:
    """_kernels._SIGNATURES as letters, read from the source."""
    tree = ast.parse((PORT / "_kernels.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "_SIGNATURES")
    return {src.value: {name.value: [e.id for e in args.elts]
                        for name, args in zip(entries.keys, entries.values)}
            for src, entries in zip(node.value.keys, node.value.values)}


@pytest.mark.parametrize("source", sorted(_table()))
def test_argument_tables_match_the_c_entry_points(source):
    table, entries = _table()[source], _c_entries(source)
    assert set(table) == set(entries), (source, set(table) ^ set(entries))
    for name, kinds in entries.items():
        assert table[name] == kinds, (source, name, [_CTYPE.get(k, k) for k in kinds])
