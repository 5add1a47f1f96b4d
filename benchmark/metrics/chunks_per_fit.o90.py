"""Chunks the adaptive loop evaluated, per fit: launches of the batched
4-point solve ``solve_soa_kernel`` (K1, one an eager chunk) in the traced
window (``torch.profiler``), over the fits."""


def read(trace, run):
    launches = trace.kernels_named("solve_soa_kernel")
    if not launches or not run["requests"]:
        return None
    return len(launches) / run["requests"]
