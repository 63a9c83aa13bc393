#!/usr/bin/env python3
"""chip_smoke.py's phase 7, the multi-card path, alone.

Builds the kernels at nq = 7, then runs ``chip_smoke.multicard_checks``:
one worker process per visible card (at most four) in one NCCL group, each
finding its card through ``initialize_distributed``; the knot axis over 2
and 4 cards, the 2 x 2 (instance, knot) grid and the fleet over the
instance axis, each held to the one-card run, and their times (with one
visible card: one process over NCCL held to ``KnotMesh(1)``).  Prints the
card line, ``nvidia-smi topo -m`` and the phase's checks and times, and
writes the phase's result to ``OUT`` (default ``results/multicard.json``).

    python3 tools/torch_port_multicard.py [TREE] [--out OUT]

TREE (default: this checkout) is the source tree whose chip_smoke.py and
package run, e.g. one unpacked by ``git archive``.  Needs a CUDA card;
exits non-zero if a check fails or a worker fails or hangs; imports
nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
import time
import types
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="results/multicard.json")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    import chip_smoke as cs
    from mpcgpu_tpu_torch import _kernels

    if not torch.cuda.is_available():
        print("torch_port_multicard: no CUDA card", file=sys.stderr)
        return 2
    print(cs.card_line(), f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible card(s)", flush=True)
    print(subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                         text=True, timeout=60).stdout, flush=True)
    failures = []

    def expect(ok: bool, msg: str):
        print(("  ok   " if ok else "  FAIL ") + msg, flush=True)
        if not ok:
            failures.append(msg)

    t0 = time.perf_counter()
    _kernels.load([(src, _kernels.NQ_DEFAULT) for src in _kernels.SOURCES])
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = cs.multicard_checks(types.SimpleNamespace(torch=torch, dev=dev,
                                                    expect=expect))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(res, card=cs.card_line()), indent=1))
    print(json.dumps({k: v for k, v in res.items() if k != "summary"}))
    print(f"phase 7 in {time.perf_counter() - t0:.1f} s; failed checks: "
          f"{failures or 'none'}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
