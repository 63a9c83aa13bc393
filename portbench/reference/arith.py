"""The arithmetic the reference computes in.

``Arith("f64")`` is the reference that judges a run.  The lower precisions
serve the control of the check (the reference put in the program's place
one step below the precision the configuration states): ``"tf32"`` is f32
whose matrix products round their operands to TF32's 10-bit mantissa, as a
tensor core does when TF32 is allowed, and accumulate in f32; ``"bf16"``
rounds the operands to bfloat16 instead.  The rounding is written out here,
not left to a library flag, so that it happens whatever kernel a product
lands on.  A rounded operand keeps its unrounded tangent, so forward-mode
derivatives pass through the rounding (the primal products round, the
tangents' other operand rounds).
"""

from __future__ import annotations

import torch

MODES = ("f64", "f32", "tf32", "bf16")


def round_bits(x, bits: int):
    """f32 x rounded to the nearest value of ``bits`` significant bits
    (Veltkamp's splitting: plain f32 arithmetic, so it also runs under
    ``vmap``)."""
    c = x * float(2 ** (24 - bits) + 1)
    return c - (c - x)


def round_tf32(x):
    """To TF32's 11 significant bits (10 stored)."""
    return round_bits(x, 11)


def round_bf16(x):
    """To bfloat16's 8 significant bits (7 stored)."""
    return round_bits(x, 8)


class Arith:
    """dtype of every tensor, and the rounding of matrix-product operands."""

    def __init__(self, mode: str = "f64"):
        if mode not in MODES:
            raise ValueError(f"unknown arithmetic {mode!r}; one of {MODES}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "f64" else torch.float32
        self._round = {"tf32": round_tf32, "bf16": round_bf16}.get(mode)

    def r(self, x):
        if self._round is None:
            return x
        xd = x.detach()
        return x + (self._round(xd) - xd)

    def mm(self, a, b):
        """a @ b over leading dims."""
        return self.r(a) @ self.r(b)

    def mv(self, M, v):
        """M (..., m, n) times v (..., n)."""
        return (self.r(M) @ self.r(v)[..., None])[..., 0]

    def mtv(self, M, v):
        """M^T v."""
        return self.mv(M.transpose(-1, -2), v)
