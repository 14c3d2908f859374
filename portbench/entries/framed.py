"""`tpu_snappy_torch.framing.compress` of each input with the sidecar
policy of the configuration's container ("auto" in framed-default), one
call after another: the call the CLI makes for `compress --framed
--sidecar auto`, its encode through parallel.shard on one shard.

The check parses and decodes the sampled streams with the plain framed
reference (`reference_framed.check`): every byte of a data chunk that
does not decode or fails its CRC counts as wrong, as does the whole
input where the stream does not parse; each 0x80 or 0x81 chunk that
does not hold counts as a bad sidecar, and each compressed chunk that
the policy promises a sidecar and that has none as a missing one. The
control is the reference's framed encoder with each chunk's CRC written
unmasked: it breaks "every data chunk's CRC is the masked CRC-32C of its
uncompressed bytes"."""

from __future__ import annotations

import json
import pathlib

from tpu_snappy_torch import framing
from tpu_snappy_torch.ops import decode

from .. import reference_framed

#: The configuration of the framed traffic, whose container block gives
#: the sidecar policy of the calls and what the check holds them to.
CONFIG = (pathlib.Path(__file__).resolve().parent.parent / "configs"
          / "framed-default.json")


class Entry:
    def __init__(self, codec, inputs: list, device: str):
        # Without the native library "auto" writes no depth hints: the
        # stream would be another than the configuration's.
        if decode.native_golden() is None:
            raise RuntimeError("the native library does not build here, so "
                               "sidecar 'auto' would write no depth hints")
        self.container = json.loads(CONFIG.read_text())["container"]
        self.codec, self.inputs, self.device = codec, inputs, device

    def warm_up(self) -> None:
        for _ in range(2):
            self.call(0)

    def call(self, k: int):
        return len(self.inputs[k]), framing.compress(
            self.inputs[k], self.codec, None, self.container["sidecar"],
            device=self.device)

    def control(self, k: int) -> bytes:
        return reference_framed.compress(self.inputs[k], masked=False)

    def check(self, sample: list) -> dict:
        wrong = bad = missing = 0
        for k, stream in sample:
            w, b, m = reference_framed.check(stream, self.inputs[k],
                                             self.container)
            wrong, bad, missing = wrong + w, bad + b, missing + m
        return {"mismatched_bytes": (wrong, 0, "<="),
                "bad_sidecars": (bad, 0, "<="),
                "missing_sidecars": (missing, 0, "<=")}
