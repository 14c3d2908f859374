"""Stream bytes the window's completed calls wrote over their input
bytes."""

from portbench import readers


def read(obs):
    into = readers.done_in(obs)
    return readers.done_out(obs) / into if into else None
