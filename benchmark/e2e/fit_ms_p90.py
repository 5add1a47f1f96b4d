"""The 90th percentile of the host milliseconds of one fit, over every fit
of the window (linear between order statistics, as ``statistics.quantiles``
does with ``method='inclusive'``)."""

import statistics


def read(window):
    lat = window["latencies_s"]
    if len(lat) < 2:
        return 1e3 * lat[0]
    return 1e3 * statistics.quantiles(lat, n=10, method="inclusive")[8]
