"""As kernel_roofline, over the kernel calls inside ops.encode._match:
the window keys, the flattening fills and the matcher."""

from portbench import readers

SPANS = {"tpu_snappy_torch.ops.encode:_match": None}


def read(obs):
    return readers.roofline(obs, inside="_match")
