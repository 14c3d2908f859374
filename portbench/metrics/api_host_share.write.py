"""Share of each api.compress call's wall time outside
ops.encode.encode_corpus_compact: blocking and padding the input, the
copy to the card, the stream's fetch and the join."""

from portbench import readers

SPANS = {"tpu_snappy_torch.ops.encode:encode_corpus_compact": None}


def read(obs):
    return readers.outside_share(obs, "encode_corpus_compact")
