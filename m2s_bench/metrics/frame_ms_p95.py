"""The 95th percentile of all the window's frames' call-to-image times."""

import statistics


def read(run):
    ms = [s * 1e3 for s in run.latencies_s]
    if len(ms) < 2:
        return ms[0] if ms else None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
