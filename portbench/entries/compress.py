"""`tpu_snappy_torch.api.compress` of each input, one call after another.

The check decodes the sampled streams with the plain reference decoder
and counts the bytes in which each differs from its input, or the whole
input where the stream does not decode. The control is the reference's
greedy encoder with its match test cut to the 4-byte hash
(`reference.compress_unverified`): it breaks "every stream decodes to its
input"."""

from __future__ import annotations

from tpu_snappy_torch import api

from .. import reference


class Entry:
    def __init__(self, codec, inputs: list, device: str):
        self.codec, self.inputs, self.device = codec, inputs, device

    def warm_up(self) -> None:
        for _ in range(2):
            self.call(0)

    def call(self, k: int):
        return len(self.inputs[k]), api.compress(self.inputs[k], self.codec,
                                                 device=self.device)

    def control(self, k: int) -> bytes:
        return reference.compress_unverified(self.inputs[k])

    def check(self, sample: list) -> dict:
        wrong = 0
        for k, stream in sample:
            try:
                got = reference.decompress(stream)
            except ValueError:
                got = b""
            wrong += reference.mismatched(got, self.inputs[k])
        return {"mismatched_bytes": (wrong, 0, "<=")}
