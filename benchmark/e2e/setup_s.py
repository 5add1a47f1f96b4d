"""Seconds from the start of the process to the first timed request: the
program's import and kernel library load (its build in a fresh checkout),
the inputs made on the device from the seed, and the warm-up."""


def read(window):
    return window["setup_s"]
