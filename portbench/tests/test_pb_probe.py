"""The trace reduction on a made-up trace: the device's busy union
inside the window, the device time each kernel mark launched (by the
launch's correlation id), and the idle gaps named by the innermost span
open on the host."""

import pytest
import torch

from portbench import probe

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, t0, t1, corr=0):
        self._v = (name, dev, t0, t1, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]


EVENTS = [
    Ev("pb.call", CPU, 0, 1000),
    Ev("pb.span.encode_blocks", CPU, 100, 900),
    Ev("pb.kernel.matcher_block_packed", CPU, 200, 300),
    Ev("cudaLaunchKernel", CPU, 210, 220, corr=7),
    Ev("pb.kernel.emit_block_single", CPU, 400, 450),
    Ev("cuLaunchKernel", CPU, 410, 415, corr=8),
    Ev("cudaMemsetAsync", CPU, 600, 605, corr=9),
    Ev("matcher_kernel<14, false>", CUDA, 250, 550, corr=7),
    Ev("emit_single_kernel", CUDA, 500, 700, corr=8),
    Ev("Memset (Device)", CUDA, 950, 1100, corr=9),
    Ev("pb.kernel.matcher_block_packed", CUDA, 250, 550),
]


def test_reduce_trace():
    red = probe.reduce_trace(EVENTS, kernel_calls=2)
    # busy: [250, 700] and [950, 1000] inside the window [0, 1000]
    assert red["busy_s"] == pytest.approx(500e-9)
    assert red["window_s"] == pytest.approx(1000e-9)
    assert red["kernel_device_s"] == pytest.approx([300e-9, 200e-9])
    assert red["device_ops"]["matcher_kernel<14, false>"] == pytest.approx(
        300e-9)
    # gaps [0, 250) mid 125 in encode_blocks; [700, 950) mid 825 there too
    assert red["idle_gaps"] == pytest.approx({"span.encode_blocks": 500e-9})


def test_marks_that_do_not_match_the_calls_give_no_kernel_times():
    assert probe.reduce_trace(EVENTS, kernel_calls=3)[
        "kernel_device_s"] is None
