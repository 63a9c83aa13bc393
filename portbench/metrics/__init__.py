"""The per-layer metrics' readers: ``<metric name>.py`` holds ``read(rec)``,
which returns the metric from the run's record, or None where the record
holds nothing to read (the metric is then left out of the result line).
``rec``: ``host_s``, ``latency_s``, ``pcg_iters`` (the measured window's
updates), ``traced`` (the traced segment: ``busy_s``, ``window_s``,
``device_s_by_op``, ``calls_by_op``, its updates' ``pcg_iters``), ``cfg``
and ``peaks``."""
