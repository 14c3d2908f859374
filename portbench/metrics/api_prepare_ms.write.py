"""Milliseconds a call of the program's `api.prepare` span: the input
blocked into 64 KiB rows, padded to whole waves and taken by
torch.from_numpy (host clock)."""

from portbench import spans

SPANS = {spans.HARVEST: spans.harvest}


def read(obs):
    return spans.ms_per_span(obs, "api.prepare")
