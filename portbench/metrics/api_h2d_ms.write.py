"""Milliseconds a call of the program's `api.h2d` span: the input's rows
and lengths copied to the card from pageable memory, which the host
waits for (host clock)."""

from portbench import spans

SPANS = {spans.HARVEST: spans.harvest}


def read(obs):
    return spans.ms_per_span(obs, "api.h2d")
