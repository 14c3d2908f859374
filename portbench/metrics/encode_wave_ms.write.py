"""Milliseconds of ops.encode.encode_blocks a 128-block wave, the span
waited for at its end."""

from portbench import readers

SPANS = {"tpu_snappy_torch.ops.encode:encode_blocks": None}


def read(obs):
    return readers.mean_ms(obs, "encode_blocks")
