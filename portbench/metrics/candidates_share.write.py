"""Share of encode_blocks' time in ops.encode._candidate_offsets: the
pair sort and the rank-space candidate table."""

from portbench import readers

SPANS = {"tpu_snappy_torch.ops.encode:encode_blocks": None,
         "tpu_snappy_torch.ops.encode:_candidate_offsets": None}


def read(obs):
    return readers.share(readers.span_s(obs, "_candidate_offsets"),
                         readers.span_s(obs, "encode_blocks"))
