"""Milliseconds a call of the program's `framing.sidecar` span: every
compressed chunk's decode sidecar built on the host, a 0x80 root map or
0x81 depth hints (sidecar.build, sidecar.build_depth), in one pass
before assembly (host clock)."""

from portbench import spans

SPANS = {spans.HARVEST: spans.harvest}


def read(obs):
    return spans.ms_per_span(obs, "framing.sidecar")
