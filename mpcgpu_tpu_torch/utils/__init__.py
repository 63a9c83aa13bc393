"""numpy-only helpers: trajectory fixtures, experiment statistics, checkpoints."""
