"""Host-facing codec API of the PyTorch port: bytes in, bytes out.

Port of tpu_snappy/api.py at any CodecConfig: `compress(data, cfg)` and
`decompress(comp, cfg)` give the JAX package's bytes for the same cfg
(DEFAULT_CONFIG or a preset such as TURBO_CONFIG); the framed container
is framing.py. The entry points run on the CUDA card (`device="cuda"`)
unless the caller passes `device="cpu"`; with no CUDA device visible, the
default raises instead of falling back to the CPU. Multi-block inputs run
in waves of `wave` blocks (or fragments) per batched device call; the
wave width never changes the output bytes. compress runs
encode_corpus_compact and fetches the payload from the device once, as the
JAX API does: the whole padded input, its encoded rows and the compacted
stream stay on the device together, so compress's device memory grows
with the input (PERF.md §5 gives the bytes per input byte), while the
working set of the kernels is bounded by the wave. decompress holds one
wave at a time.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from . import format as fmt
from . import reference_codec
from .config import CodecConfig, DEFAULT_CONFIG
from .ops import decode as ops_decode
from .ops import encode as ops_encode
from .utils import profiling

#: Blocks (or fragments) per batched device call, chosen for device
#: memory. The kernels' working set grows linearly with the wave (compress
#: adds buffers that grow with the whole input, see the module docstring):
#: a 16 MiB round trip
#: at 128 peaked at 1.69 GB (1687159808 bytes, NVIDIA H100 80GB HBM3,
#: 700 W), about 13 MB per block, most of it the pair sort and the packed
#: candidate table (it was 5.6 GB while the encoder's XLA-form matcher
#: held (B, 65536, 14, 14) booleans). 128 blocks (8 MiB of input) halve
#: the decoder's per-wave parse-scan cost against 64 and leave most of an
#: 80 GB card, or of a CPU host's memory, free.
API_WAVE = 128

#: Inputs below one block take the host codec at DEFAULT_CONFIG
#: (tpu_snappy/api.py:50), so the port's API bytes match the JAX API's.
SMALL_INPUT_BYTES = fmt.BLOCK_SIZE


@dataclasses.dataclass
class DecodeStats:
    """What api.decompress did with one stream."""
    path: str = "device"  # "device", "host-small" or "host-fallback"
    fragments: int = 0    # fragments decoded on the device
    spliced: int = 0      # of those, re-decoded on the host (ok=False)
    #: Dense doubling rounds (gather_block launches) of each wave.
    dense_rounds: list = dataclasses.field(default_factory=list)


def _block_count(n: int, block_size: int) -> int:
    """Blocks of `block_size` bytes that hold `n` bytes (one for none)."""
    return max(1, -(-n // block_size))


def _block_lengths(n: int, block_size: int, rows: int) -> np.ndarray:
    """(rows,) int32: the bytes of `n` in each block of `block_size`,
    zero in rows past the input."""
    return np.minimum(np.maximum(n - np.arange(rows) * block_size, 0),
                      block_size).astype(np.int32)


def _to_blocks(data: bytes, block_size: int = fmt.BLOCK_SIZE):
    """Split input into blocks of `block_size` bytes, each zero-padded to a
    (65536,) row, with a length vector."""
    n = len(data)
    nblocks = _block_count(n, block_size)
    arr = np.zeros((nblocks, fmt.BLOCK_SIZE), dtype=np.uint8)
    flat = np.frombuffer(data, dtype=np.uint8)
    if block_size == fmt.BLOCK_SIZE:
        arr.reshape(-1)[:n] = flat
    else:
        for i in range(nblocks):
            chunk = flat[i * block_size:(i + 1) * block_size]
            arr[i, :len(chunk)] = chunk
    return arr, _block_lengths(n, block_size, nblocks)


def _byte_view(data) -> torch.Tensor:
    """A 1-D uint8 CPU tensor over the caller's bytes, without a copy; it
    is only ever read, as a copy's source. torch warns that it cannot mark
    a tensor over a read-only buffer (bytes) read-only; that warning is
    kept from the caller."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given buffer is not writable",
                                UserWarning)
        return torch.frombuffer(data, dtype=torch.uint8)


def _device(device) -> torch.device:
    """The device to run on; raises for CUDA when no CUDA device is
    visible (the API never falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run on the CPU")
    return dev


def _host_compress(data: bytes) -> bytes:
    golden = ops_decode.native_golden()
    if golden is not None:
        return golden.compress(data)
    return reference_codec.compress(data)


def _host_decompress(comp: bytes) -> bytes:
    golden = ops_decode.native_golden()
    if golden is not None:
        try:
            return golden.uncompress(comp)
        except ValueError:
            # The Python decoder re-raises with a precise message (or
            # succeeds on streams the native capacity checks refuse).
            pass
    return reference_codec.decompress(comp)


def compress(data: bytes, cfg: CodecConfig = DEFAULT_CONFIG, *,
             device="cuda", small_fastpath: bool = True,
             wave: int | None = None) -> bytes:
    """Compress to a standard Snappy stream (varint preamble + elements)
    on `device`, encoding blocks of cfg.block_size bytes at `cfg`.
    small_fastpath=False forces the device pipeline below one block (the
    host path applies only at DEFAULT_CONFIG, as in the JAX package)."""
    device = _device(device)
    if (small_fastpath and len(data) < SMALL_INPUT_BYTES
            and cfg == DEFAULT_CONFIG):
        return _host_compress(data)
    with profiling.span("api.compress"):
        with profiling.span("api.prepare"):
            n, bs = len(data), cfg.block_size
            nb = _block_count(n, bs)
            # Pad to whole waves with zero-length rows
            # (tpu_snappy/api.py:92), encode every wave into one tensor,
            # compact on the device and fetch exactly the payload once.
            w = min(wave or API_WAVE, nb)
            rows = nb + -nb % w
            # The rows are zeroed on the device and take the input in one
            # copy from the caller's bytes: no host copy of the input.
            src = _byte_view(data) if n else None
            blocks = torch.zeros((rows, fmt.BLOCK_SIZE), dtype=torch.uint8,
                                 device=device)
            lengths = torch.from_numpy(_block_lengths(n, bs, rows))
        with profiling.span("api.h2d"):
            if n and bs == fmt.BLOCK_SIZE:
                blocks.view(-1)[:n].copy_(src)
            elif n:
                # One copy to the device, then a device copy into the rows.
                blocks[:nb, :bs].copy_(torch.nn.functional.pad(
                    src.to(device), (0, nb * bs - n)).view(nb, bs))
            lengths = lengths.to(device)
        dense, _, total = ops_encode.encode_corpus_compact(
            blocks, lengths, cfg, wave=w)
        with profiling.span("api.fetch"):
            payload = dense[:total].cpu()
        with profiling.span("api.join"):
            return fmt.varint_encode(len(data)) + payload.numpy().tobytes()


def decompress(comp: bytes, cfg: CodecConfig = DEFAULT_CONFIG, *,
               device="cuda", small_fastpath: bool = True,
               wave: int | None = None) -> bytes:
    """Decompress a standard Snappy stream (ours or any other encoder's)
    on `device`, with the TPU-default resolve ("tiledtail"). Fragments
    that fail device validation (corrupt, or valid but exotic) re-decode
    on the host; corrupt streams raise ValueError. `cfg` only gates the
    small-input host path (DEFAULT_CONFIG only), as in the JAX package."""
    return decompress_with_stats(comp, cfg, device=device,
                                 small_fastpath=small_fastpath,
                                 wave=wave)[0]


def decompress_with_stats(comp: bytes, cfg: CodecConfig = DEFAULT_CONFIG, *,
                          device="cuda", small_fastpath: bool = True,
                          wave: int | None = None):
    """api.decompress, also returning a DecodeStats of the path taken."""
    device = _device(device)
    stats = DecodeStats()
    total, start = fmt.varint_decode(comp)
    if total == 0:
        if len(comp) != start:
            raise ValueError("trailing bytes after empty stream")
        return b"", stats
    if (small_fastpath and total < SMALL_INPUT_BYTES
            and cfg == DEFAULT_CONFIG):
        stats.path = "host-small"
        return _host_decompress(comp), stats
    try:
        frags, clens, ulens = ops_decode.fragment_table(comp, start, total)
    except ops_decode.FragmentFallback:
        stats.path = "host-fallback"
        return reference_codec.decompress(comp), stats
    nf = len(ulens)
    width = ops_decode.frag_width(clens)
    w = wave or API_WAVE
    outs, oks = [], []
    for s in range(0, nf, w):
        ft = torch.from_numpy(
            np.ascontiguousarray(frags[s:s + w, :width])).to(device)
        ct = torch.from_numpy(clens[s:s + w]).to(device)
        ut = torch.from_numpy(ulens[s:s + w]).to(device)
        out, ok, rounds = ops_decode.decode_fragments(ft, ct, ut)
        stats.dense_rounds.append(rounds)
        outs.append(out.cpu().numpy())
        oks.append(ok.cpu().numpy())
    out = np.concatenate(outs)
    ok = np.concatenate(oks)
    stats.fragments = nf
    stats.spliced = int((~ok).sum())
    if stats.spliced:
        result = _splice_failed_fragments(frags, clens, ulens, out, ok)
    else:
        result = b"".join(out[i, : ulens[i]].tobytes() for i in range(nf))
    if len(result) != total:
        raise ValueError("length mismatch vs preamble")
    return result, stats


def _splice_failed_fragments(frags, clens, ulens, out: np.ndarray,
                             ok: np.ndarray) -> bytes:
    """Re-decode only the failed fragments on the host, with the decoded
    prefix as copy context (tpu_snappy/api.py:164)."""
    parts = [out[i, : ulens[i]].tobytes() if ok[i] else None
             for i in range(len(ulens))]
    return _splice_parts(frags, clens, ulens, parts, ok)


def _splice_parts(frags, clens, ulens, parts, ok) -> bytes:
    """Join per-fragment device bytes; failed fragments re-decode
    sequentially after the spliced prefix. Corrupt fragments raise with
    their index."""
    ctx = bytearray()
    for i in range(len(ulens)):
        if ok[i]:
            ctx += parts[i]
            continue
        before = len(ctx)
        try:
            reference_codec.decompress_elements(
                frags[i].tobytes(), 0, int(clens[i]), ctx)
        except (ValueError, IndexError) as host_err:
            raise ValueError(
                f"invalid Snappy stream: fragment {i} of {len(ulens)} "
                f"failed validation ({host_err})") from host_err
        if len(ctx) - before != ulens[i]:
            raise ValueError(
                f"invalid Snappy stream: fragment {i} of {len(ulens)} "
                f"decoded {len(ctx) - before} bytes, expected {ulens[i]}")
    return bytes(ctx)
