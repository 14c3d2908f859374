"""Share of the framed streams' bytes in 0x80 root-map and 0x81
depth-hint chunks, headers included, over the window's calls of
framing.compress: read from each returned stream's chunk headers."""

#: The sidecars' chunk types, and the stream identifier's bytes.
SIDECAR_TYPES = (0x80, 0x81)
STREAM_ID_BYTES = 10


def count(stream) -> dict:
    """Sidecar and stream bytes of one framed stream."""
    side, pos = 0, STREAM_ID_BYTES
    while pos + 4 <= len(stream):
        end = pos + 4 + int.from_bytes(stream[pos + 1:pos + 4], "little")
        if stream[pos] in SIDECAR_TYPES:
            side += end - pos
        pos = end
    return {"framing.sidecar_bytes": side,
            "framing.stream_bytes": len(stream)}


SPANS = {"tpu_snappy_torch.framing:compress": count}


def read(obs):
    side = sum(v for _, v in obs["counters"].get("framing.sidecar_bytes",
                                                 []))
    total = sum(v for _, v in obs["counters"].get("framing.stream_bytes",
                                                  []))
    return 100.0 * side / total if total else None
