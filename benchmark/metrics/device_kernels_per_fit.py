"""Device kernels, copies and fills launched in the traced window, per fit
(``torch.profiler``): the per-pair tail's eager launches set it."""


def read(trace, run):
    if not trace.kernels or not run["requests"]:
        return None
    return len(trace.kernels) / run["requests"]
