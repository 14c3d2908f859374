"""The port's command line (python -m tpu_snappy_torch): main(argv)
in process with `--device cpu` on files under tmp_path.

Raw, framed with a sidecar, Hadoop, a preset, `--mesh 2` and `--stream`
(raw and framed) each write the API's bytes (api.compress,
framing.compress, hadoop.compress, shard.encode_dp) and decompress back;
the raw stream also equals the JAX CLI's. The mutually exclusive flags
exit with an error, as in tests/test_cli.py, and the default device
raises without a card. The `gpu` test runs the CLI on the card.
"""

import pytest
import torch

from tpu_snappy.__main__ import main as jax_main

from tpu_snappy_torch import api, framing, hadoop
from tpu_snappy_torch.__main__ import main
from tpu_snappy_torch.config import TURBO_CONFIG
from tpu_snappy_torch.parallel import mesh as meshlib, shard

from torch_edges import block_mix
from torch_threads import share_cores

share_cores()

CPU = ["--device", "cpu"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    return block_mix(5 * 65536 + 4321)


@pytest.fixture()
def sample(tmp_path, data):
    p = tmp_path / "in.bin"
    p.write_bytes(data)
    return p


def _round_trip(sample, tmp_path, flags, want: bytes, decode_flags=None):
    comp, back = tmp_path / "o.sz", tmp_path / "o.bin"
    assert main(["compress", str(sample), str(comp)] + flags + CPU) == 0
    assert comp.read_bytes() == want
    dflags = flags if decode_flags is None else decode_flags
    assert main(["decompress", str(comp), str(back)] + dflags + CPU) == 0
    assert back.read_bytes() == sample.read_bytes()
    return comp


def test_cli_raw(sample, tmp_path, data, capsys):
    comp = _round_trip(sample, tmp_path, [], api.compress(data, device="cpu"))
    assert "ratio" in capsys.readouterr().out
    jcomp = tmp_path / "j.sz"
    assert jax_main(["compress", str(sample), str(jcomp)]) == 0
    assert jcomp.read_bytes() == comp.read_bytes()
    assert main(["roundtrip", str(sample)] + CPU) == 0
    assert capsys.readouterr().out.strip().endswith(";OK")


def test_cli_framed_with_sidecar(sample, tmp_path, data):
    _round_trip(sample, tmp_path, ["--framed", "--sidecar", "auto"],
                framing.compress(data, sidecar="auto", device="cpu"),
                decode_flags=["--framed"])


def test_cli_hadoop(sample, tmp_path, data):
    _round_trip(sample, tmp_path, ["--hadoop"],
                hadoop.compress(data, device="cpu"))


def test_cli_preset(sample, tmp_path, data):
    _round_trip(sample, tmp_path, ["--turbo"],
                api.compress(data, TURBO_CONFIG, device="cpu"),
                decode_flags=[])
    assert main(["roundtrip", str(sample), "--ultra"] + CPU) == 0


def test_cli_mesh(sample, tmp_path, data):
    want = shard.encode_dp(data, meshlib.make_mesh(2, device="cpu"))
    assert want == api.compress(data, device="cpu")
    _round_trip(sample, tmp_path, ["--mesh", "2"], want)
    _round_trip(sample, tmp_path, ["--mesh", "2", "--framed"],
                framing.compress(data, device="cpu"))


def test_cli_stream(sample, tmp_path, data):
    comp = tmp_path / "s.sz"
    assert main(["compress", str(sample), str(comp), "--stream",
                 "--blocks-per-wave", "2"] + CPU) == 0
    assert comp.read_bytes() == api.compress(data, device="cpu")
    framed, back = tmp_path / "s.szf", tmp_path / "s.bin"
    assert main(["compress", str(sample), str(framed), "--stream",
                 "--framed", "--sidecar", "always", "--blocks-per-wave",
                 "2"] + CPU) == 0
    assert framed.read_bytes() == framing.compress(data, sidecar="always",
                                                   device="cpu")
    assert main(["decompress", str(framed), str(back), "--stream",
                 "--framed"] + CPU) == 0
    assert back.read_bytes() == data


@pytest.mark.parametrize("flags", [
    ["--framed", "--hadoop"], ["--hadoop", "--mesh", "2"],
    ["--hadoop", "--stream"], ["--sidecar", "auto"], ["--fast", "--turbo"],
    ["--turbo", "--ultra"], ["--device", "tpu"]])
def test_cli_exclusive_flags_exit(sample, tmp_path, flags):
    with pytest.raises(SystemExit):
        main(["compress", str(sample), str(tmp_path / "x")] + flags
             + (CPU if "--device" not in flags else []))


def test_cli_stream_decode_needs_framed(sample, tmp_path):
    with pytest.raises(SystemExit):
        main(["decompress", str(sample), str(tmp_path / "x"), "--stream"]
             + CPU)


def test_cli_defaults_to_the_card(sample, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in ([], ["--framed"], ["--hadoop"], ["--mesh", "1"],
                  ["--stream"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["compress", str(sample), str(tmp_path / "x")] + flags)


@pytest.mark.gpu
def test_cli_on_the_card(sample, tmp_path, data, cuda):
    for flags, want in (([], api.compress(data, device="cpu")),
                        (["--framed", "--sidecar", "auto"],
                         framing.compress(data, sidecar="auto", device="cpu")),
                        (["--mesh", "1", "--stream"],
                         api.compress(data, device="cpu"))):
        comp = tmp_path / "c.sz"
        assert main(["compress", str(sample), str(comp)] + flags) == 0
        assert comp.read_bytes() == want
