"""The port's kernel calls in the window: their bounds (yardstick.bound,
per call) summed over the device seconds each launched (the profiler's
kernels, memsets and copies, by the launch's host time inside the
wrapper call) summed."""

from portbench import readers


def read(obs):
    return readers.roofline(obs)
