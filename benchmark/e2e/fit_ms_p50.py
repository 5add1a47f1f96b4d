"""Median host milliseconds of one fit, over every fit of the window."""

import statistics


def read(window):
    return 1e3 * statistics.median(window["latencies_s"])
