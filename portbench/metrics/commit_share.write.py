"""Share of encode_blocks' time in ops.scan.commit_bounded, the encode
parse's commit scan."""

from portbench import readers

SPANS = {"tpu_snappy_torch.ops.encode:encode_blocks": None,
         "tpu_snappy_torch.ops.scan:commit_bounded": None}


def read(obs):
    return readers.share(readers.span_s(obs, "commit_bounded"),
                         readers.span_s(obs, "encode_blocks"))
