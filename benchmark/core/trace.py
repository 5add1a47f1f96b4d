"""What one ``torch.profiler`` trace of the traced window says.

Read from the profiler's raw events (``prof.profiler.kineto_results
.events()``): a fit launches some 31,000 kernels, and building the
profiler's event tree for a window of them takes minutes.  The window is the
host range ``bench/window`` that the harness records around its traced
requests.  Device events are the kernels, copies and fills that ran on the
card; the device-side copies of host ranges (events of the device whose
name is also a host event's) are not device work.
"""

from __future__ import annotations

import bisect
from collections import Counter

WINDOW = "bench/window"
#: Host events no idle gap is charged to: the harness's own ranges and the
#: CUDA runtime's calls (a gap is charged to the operation that issued them).
_NOT_OPERATIONS = ("bench/", "cuda")


class TraceView:
    """The device kernels and host ranges of the traced window."""

    def __init__(self, events):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = list(events)
        host_names = {e.name() for e in events if e.device_type() != cuda}
        kernels, host = [], []
        for e in events:
            item = (e.start_ns(), e.end_ns(), e.name())
            if e.device_type() == cuda:
                if item[2] not in host_names:
                    kernels.append(item)
            else:
                host.append(item)
        window = [h for h in host if h[2] == WINDOW]
        if window:
            self.t0, self.t1 = window[0][0], window[0][1]
        else:
            every = host + kernels
            self.t0 = min((x[0] for x in every), default=0)
            self.t1 = max((x[1] for x in every), default=0)
        self.kernels = sorted(k for k in kernels if self.t0 <= k[0] <= self.t1)
        self.host = sorted(h for h in host if self.t0 <= h[0] <= self.t1)
        self._busy = self._merge()

    def _merge(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for start, end, _ in self.kernels:
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return [(s, min(e, self.t1)) for s, e in out]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return sum(e - s for s, e in self._busy) / 1e9

    def span_ms(self, *names: str) -> float:
        """Host milliseconds of the ranges named ``names``, summed."""
        return sum(e - s for s, e, n in self.host if n in names) / 1e6

    def kernels_named(self, part: str) -> list[tuple[int, int, str]]:
        """The device kernels whose name holds ``part``."""
        return [k for k in self.kernels if part in k[2]]

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took the most summed seconds."""
        total = Counter()
        for s, e, n in self.kernels:
            total[n[:120]] += (e - s) / 1e9
        return [[n, t] for n, t in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle device time by what the host was doing: each gap between
        device operations is charged to the innermost host operation that
        was running at its midpoint."""
        gaps, cursor = [], self.t0
        for s, e in self._busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if self.t1 > cursor:
            gaps.append((cursor, self.t1))
        ops = sorted((s, -e, n) for s, e, n in self.host
                     if not n.startswith(_NOT_OPERATIONS))
        starts = [s for s, _, _ in ops]
        total, stack, j = Counter(), [], 0
        for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (g0 + g1) // 2
            k = bisect.bisect_right(starts, mid)
            while j < k:
                s = ops[j][0]
                while stack and -stack[-1][1] < s:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and -stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "host (no operation)"
            total[name[:120]] += (g1 - g0) / 1e9
        return [[n, t] for n, t in total.most_common(top)]
