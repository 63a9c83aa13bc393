"""Every name the JAX package exports resolves in the port, but the ones
ROADMAP.md lists as not ported yet.

The JAX ``__all__`` lists are read from the JAX package here, in the test;
the port never imports it.
"""

import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("", ".models", ".ops", ".solver", ".sim", ".parallel")
# exported by the JAX package, not ported yet (each named in ROADMAP.md):
# none since the instance axis (parallel.shard_batched_problem) was ported
NOT_PORTED = {}


@pytest.mark.parametrize("sub", PACKAGES)
def test_jax_exports_resolve_in_the_port(sub):
    jax_pkg = importlib.import_module("mpcgpu_tpu" + sub)
    port = importlib.import_module("mpcgpu_tpu_torch" + sub)
    skip = NOT_PORTED.get(sub, set())
    missing = [n for n in jax_pkg.__all__ if n not in skip and not hasattr(port, n)]
    assert not missing, f"mpcgpu_tpu_torch{sub} lacks {missing}"
    # the port lists them too, so a star import carries them
    unlisted = [n for n in jax_pkg.__all__ if n not in skip
                and n not in getattr(port, "__all__", ())]
    assert not unlisted, f"mpcgpu_tpu_torch{sub}.__all__ lacks {unlisted}"
    for n in getattr(port, "__all__", ()):
        assert hasattr(port, n), f"mpcgpu_tpu_torch{sub}.__all__ names {n}"


def test_not_ported_names_are_on_the_roadmap_and_absent():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for sub, names in NOT_PORTED.items():
        port = importlib.import_module("mpcgpu_tpu_torch" + sub)
        for n in names:
            assert f"`{n}`" in roadmap, n
            assert not hasattr(port, n), f"{n} is ported: drop it from NOT_PORTED"


def test_top_level_solver_names():
    import mpcgpu_tpu_torch
    from mpcgpu_tpu_torch.solver import sqp_solve
    from mpcgpu_tpu_torch.solver.sqp import make_sqp_solver

    assert mpcgpu_tpu_torch.sqp_solve is sqp_solve
    assert mpcgpu_tpu_torch.make_sqp_solver is make_sqp_solver
    from mpcgpu_tpu_torch.models import iiwa14
    assert mpcgpu_tpu_torch.iiwa14 is iiwa14
    with pytest.raises(AttributeError):
        mpcgpu_tpu_torch.no_such_name
