"""The trace reader on a hand-made trace: the window, and the device's busy
time as the union of its operations, less the device copies of host
ranges."""

from __future__ import annotations

import pytest
import torch

from benchmark.core.trace import WINDOW, TraceView


class _Event:
    def __init__(self, name, start, end, device):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
EVENTS = [_Event(WINDOW, 0, 1000, CPU),
          _Event("ransac/general", 100, 300, CPU),
          _Event("ransac/general", 600, 700, CPU),
          _Event("ransac/general", 600, 700, CUDA),  # a host range's copy
          _Event("k", 50, 150, CUDA), _Event("k", 140, 200, CUDA),
          _Event("k", 290, 400, CUDA), _Event("k", 650, 660, CUDA)]


def test_busy_time_is_the_union_of_device_operations():
    view = TraceView(EVENTS)
    assert view.window_s == pytest.approx(1e-6)
    assert view.busy_s == pytest.approx((150 + 110 + 10) / 1e9)

