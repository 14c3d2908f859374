"""Seconds from the process's start to the end of the warm-up: imports,
the card, the inputs, the entry's set-up and the warm-up calls."""


def read(obs):
    return obs["setup_s"]
