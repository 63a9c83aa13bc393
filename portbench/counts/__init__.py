"""Each kernel's operations and bytes (``<kernel>.py``: ``KERNEL``, the
name its launches carry in a trace, and ``work(...) -> (flops, 4-byte
words)``), frozen for the benchmark's rooflines."""
