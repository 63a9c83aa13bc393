"""Host time of the port's solve call per control update (us): from the
call into the solve until it returns, before the synchronize, averaged
over the measured window's updates (the harness's clock)."""


def read(rec):
    host = rec["host_s"]
    return 1e6 * sum(host) / len(host) if host else None
