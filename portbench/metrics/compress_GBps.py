"""Input bytes of the window's completed calls over the window's
seconds, in GB/s."""

from portbench import readers


def read(obs):
    return readers.done_in(obs) / obs["window_s"] / 1e9
