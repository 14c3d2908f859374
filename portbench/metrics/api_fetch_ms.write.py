"""Milliseconds a call of the program's `api.fetch` span: the compacted
stream fetched from the card by .cpu(), which waits for the card's queue
and then the copy (host clock)."""

from portbench import spans

SPANS = {spans.HARVEST: spans.harvest}


def read(obs):
    return spans.ms_per_span(obs, "api.fetch")
