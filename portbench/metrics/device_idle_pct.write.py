"""Share of the traced window, the first call's start to the last one's
end, in which no kernel, memset or copy ran on the card."""

from portbench import readers


def read(obs):
    return readers.idle_pct(obs)
