"""Milliseconds a call of the program's `framing.crc` span: the CRC-32C
of every 64 KiB block on the host (framing.crc32c_batch), the short last
block's redone over its own bytes (host clock)."""

from portbench import spans

SPANS = {spans.HARVEST: spans.harvest}


def read(obs):
    return spans.ms_per_span(obs, "framing.crc")
