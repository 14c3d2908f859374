"""Milliseconds a call of the program's `framing.assemble` span: every
chunk's header and masked CRC, and the join of the stream (host
clock)."""

from portbench import spans

SPANS = {spans.HARVEST: spans.harvest}


def read(obs):
    return spans.ms_per_span(obs, "framing.assemble")
