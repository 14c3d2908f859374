"""A run's check against faults planted in the timed path: each run
skips the look for a card and runs on the CPU at a small size, with the
program broken underneath, and `correct` has to come out false. The
faults a cell of one chip can have: a step that returns its state
unchanged, half of the batch left out, and an answer altered where it is
produced (no cell has an exchange between chips to leave out). A sound
run of each cell comes out correct."""

import pytest
import torch

from portbench import harness
from tpu_snappy_torch.ops import encode

SMALL = {"pool_bytes": 5 << 16, "call_bytes": 2 << 16,
         "stride_bytes": 1 << 16, "slices": 4}
CELLS = ("raw-default.write", "raw-turbo.write")


def _encode_fault(kind):
    real = encode.encode_blocks

    def broken(blocks, lengths, cfg, placement="auto"):
        out, lens = real(blocks, lengths, cfg, placement)
        if kind == "unchanged":
            rows = torch.zeros_like(out)
            rows[:, :blocks.shape[1]] = blocks
            return rows, lengths.to(torch.int32)
        lens = lens.clone()
        if kind == "half":
            lens[lens.shape[0] // 2:] = 0
        else:
            out = out.clone()
            out[0, 1] ^= 0x20
        return out, lens
    return broken


def _run(cell):
    return harness.run_cell(cell, 2**31 + 77, 0.05, False, device="cpu",
                            sizes=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, kind, monkeypatch):
    monkeypatch.setattr(encode, "encode_blocks", _encode_fault(kind))
    result = _run(cell)
    assert not result["correct"], result["compared"]
