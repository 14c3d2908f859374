"""Milliseconds a call of the program's `api.join` span: the fetched
stream's .numpy().tobytes() and its join behind the varint length (host
clock)."""

from portbench import spans

SPANS = {spans.HARVEST: spans.harvest}


def read(obs):
    return spans.ms_per_span(obs, "api.join")
