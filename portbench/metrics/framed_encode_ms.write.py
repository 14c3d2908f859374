"""Milliseconds a call of the program's `framing.encode` span: the input
blocked into 64 KiB rows (api._to_blocks), copied to the card and
encoded there through parallel.shard.encode_rows on one shard, the
payload fetched and split by block (host clock)."""

from portbench import spans

SPANS = {spans.HARVEST: spans.harvest}


def read(obs):
    return spans.ms_per_span(obs, "framing.encode")
