"""The benchmark's plain reference of one control update (``update.py``)
and the arithmetic it computes in (``arith.py``).  Imports nothing of the
program under test and nothing of JAX."""
