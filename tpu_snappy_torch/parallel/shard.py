"""Data-parallel codec over a device mesh (port of
tpu_snappy/parallel/shard.py).

Blocks shard across the mesh's devices in contiguous runs of rows
(mesh.shard_rows). Every shard runs the same wave pipeline as the API on
its own device (ops.encode.encode_corpus_compact, ops.decode's fragment
decoders, sidecar.decode_corpus_sidecar), so every kernel of the raw and
framed paths runs under the sharded paths too. The variable-length
results are put back in block order from the (offset, length) manifest.
Across processes the manifest and the payload are all-gathered over
torch.distributed on CPU tensors (gloo serves both a CPU and a CUDA run:
the gathered bytes go to the host anyway); in one process nothing is
gathered. The shards of one process run one after another on the host
(each device's queue still runs asynchronously); one process per card
(multihost) runs cards side by side.

Work is padded to whole waves of `wave = min(DP_WAVE, per-shard count)`
on every shard (DP_WAVE is the API's 128-row wave), with zero-length rows
that encode to zero bytes (and decode to nothing), so the sharded streams
are the single-device streams, and the JAX package's, byte for byte: no
block's bytes depend on the wave or the shard it runs in.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import api
from .. import format as fmt
from .. import sidecar as sc
from ..config import CodecConfig, DEFAULT_CONFIG
from ..ops import decode as ops_decode
from ..ops import encode as ops_encode
from ..ops.kernels import crc as kcrc
from . import mesh as meshlib


def pad_count(count: int, n_devices: int) -> int:
    """Work items padded to a multiple of the mesh size (shard.py:26):
    empty blocks encode to zero bytes and drop out at assembly."""
    return -(-count // n_devices) * n_devices


#: Rows per wave a shard runs (shard.py:37). JAX's 8 bounds the size of
#: the one traced program a shard compiles; the port compiles nothing, and
#: its cost is the launches a wave makes, the parse's host walk above all:
#: decode_dp of a 16 MiB stream took 1.97 s at 8-row waves and 0.142 s at
#: 128 on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 10;
#: PERF.md section 6). So a shard runs the API's 128-row waves.
DP_WAVE = 128


def layout(count: int, n_shards: int) -> tuple:
    """(wave, padded rows) for `count` items over n_shards shards: each
    shard gets a whole number of waves of min(DP_WAVE, its share), so
    small jobs stay one short wave (the rule of the JAX package's
    shard.py:204-206, at the port's wave)."""
    per = pad_count(max(count, 1), n_shards) // n_shards
    wave = min(DP_WAVE, per)
    return wave, pad_count(per, wave) * n_shards


def blocks_of(data: bytes, block_size: int, padded: int, out=None):
    """Host-side split of `data` into (padded, 65536) blocks + lengths.
    `out`, when given, is the (at least padded-row) uint8 array to fill,
    such as a pinned staging buffer's numpy view."""
    n = len(data)
    if out is None:
        arr = np.zeros((padded, fmt.BLOCK_SIZE), dtype=np.uint8)
    else:
        arr = out[:padded]
        arr[:] = 0
    flat = np.frombuffer(data, dtype=np.uint8)
    nblocks = max(1, -(-n // block_size))
    if block_size == fmt.BLOCK_SIZE:
        arr.reshape(-1)[:n] = flat
    else:
        for i in range(nblocks):
            chunk = flat[i * block_size:(i + 1) * block_size]
            arr[i, : len(chunk)] = chunk
    lengths = np.minimum(
        np.maximum(n - np.arange(padded, dtype=np.int64) * block_size, 0),
        block_size).astype(np.int32)
    return arr, lengths, nblocks


def _all_gather_rows(arr: np.ndarray, group) -> np.ndarray:
    """Concatenate every process's `arr` along dim 0, in rank order, on
    every process (the rows may differ in number: their counts go first,
    then every part padded to the largest)."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    kind = t.dtype
    if kind == torch.bool:
        t = t.to(torch.uint8)
    n = torch.tensor([t.shape[0]], dtype=torch.int64)
    counts = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(counts, n, group=group)
    counts = [int(c) for c in counts]
    most = max(counts)
    part = t.new_zeros((most,) + tuple(t.shape[1:]))
    part[: t.shape[0]] = t
    parts = [torch.empty_like(part) for _ in range(world)]
    dist.all_gather(parts, part, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(
        kind).numpy()


def fetch_global(x, mesh: meshlib.Mesh) -> np.ndarray:
    """This process's rows `x` (numpy, or a tensor on any device) joined
    with every other process's, in shard order, on every process (the
    cross-process all-gather); in one process, x on the host."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if mesh.group is None:
        return x
    return _all_gather_rows(x, mesh.group)


# ---- encode ----

def _on_shards(mesh: meshlib.Mesh, arrays: tuple) -> list:
    """Each of this process's shards' rows of every array, on the shard's
    device. arrays: numpy arrays or CPU tensors (a pinned one copies
    without blocking the host), rows on dim 0."""
    tens = [a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a)) for a in arrays]
    return [tuple(t[rows].to(dev, non_blocking=True) for t in tens)
            for dev, rows in meshlib.shard_rows(mesh, tens[0].shape[0])]


def _current(dev: torch.device):
    """A CUDA shard's device made the current device while its kernels
    launch (they launch on the current device's current stream); nothing
    for a CPU shard."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def encode_local(mesh: meshlib.Mesh, blocks, lengths,
                 cfg: CodecConfig, wave: int, *, crcs: bool = False):
    """Encode this process's shards of (padded) blocks and lengths, each on
    its device through encode_corpus_compact at `wave`. Returns (per local
    shard (dense payload tensor, out_lens tensor, total), per local shard
    the CRC-32C tensor of its rows). Nothing is gathered here (see
    gather_manifest and assemble_compact). The CRCs are computed only
    where the caller asks for them (crcs=True, the framed container's
    encode): crc32c_rows on each shard's rows before its encode, on the
    same stream; otherwise the second list is empty."""
    shards, sums = [], []
    for b, l in _on_shards(mesh, (blocks, lengths)):
        with _current(b.device):
            if crcs:
                sums.append(kcrc.crc32c_rows(b, l))
            shards.append(ops_encode.encode_corpus_compact(b, l, cfg,
                                                           wave=wave))
    return shards, sums


def gather_manifest(shards: list, mesh: meshlib.Mesh) -> np.ndarray:
    """The encoded length of every row of every shard, in block order, on
    every process (the manifest all-gather)."""
    local = np.concatenate([lens.cpu().numpy() for _d, lens, _t in shards])
    return fetch_global(local, mesh)


def assemble_compact(dense: list, lens_np: np.ndarray, nblocks: int,
                     mesh: meshlib.Mesh) -> list:
    """Host assembly from the compacted form: `dense` holds, per local
    shard, encode_local's (dense payload, out_lens, total); each payload is
    cut to its exact total and fetched once. Returns the payload pieces
    in block order (one a shard that holds blocks; across processes, one
    a process, gathered on every process). Rows past `nblocks` are
    padding and hold no bytes."""
    per = len(lens_np) // mesh.size
    first = mesh.rank * len(mesh.devices)
    pieces = []
    for i, (payload, _lens, _t) in enumerate(dense):
        g = first + i
        nb = min(max(nblocks - g * per, 0), per)
        total = int(lens_np[g * per: g * per + nb].sum())
        pieces.append(payload[:total].cpu().numpy().tobytes())
    if mesh.group is None:
        return [p for p in pieces if p]
    joined = np.frombuffer(b"".join(pieces), np.uint8)
    return [fetch_global(joined, mesh).tobytes()]


def encode_rows(blocks: np.ndarray, lengths: np.ndarray,
                mesh: meshlib.Mesh, cfg: CodecConfig = DEFAULT_CONFIG, *,
                crcs: bool = False):
    """Encode nb block rows sharded over `mesh`, padded to `layout`.
    Returns (payload bytes in block order, encoded lengths (nb,)); with
    crcs=True also the CRC-32C of each block's bytes (nb,) int64, computed
    on the shards' devices from the rows they encode."""
    nb = len(lengths)
    wave, padded = layout(nb, mesh.size)
    if padded != nb:
        blocks = np.pad(blocks, ((0, padded - nb), (0, 0)))
        lengths = np.pad(lengths, (0, padded - nb))
    shards, sums = encode_local(mesh, blocks, lengths, cfg, wave,
                                crcs=crcs)
    lens_np = gather_manifest(shards, mesh)
    payload = b"".join(assemble_compact(shards, lens_np, nb, mesh))
    if not crcs:
        return payload, lens_np[:nb]
    # One fetch a shard, then the cross-process all-gather, as the
    # manifest's.
    local = np.concatenate([s.cpu().numpy() for s in sums])
    return payload, lens_np[:nb], fetch_global(local, mesh)[:nb]


def encode_dp(data: bytes, mesh: meshlib.Mesh,
              cfg: CodecConfig = DEFAULT_CONFIG) -> bytes:
    """Compress `data` with blocks sharded data-parallel over `mesh`.
    There is no small-input host path: every block takes the device
    pipeline, as in the JAX package."""
    n = len(data)
    nblocks = max(1, -(-n // cfg.block_size))
    blocks, lengths, _ = blocks_of(data, cfg.block_size, nblocks)
    payload, _ = encode_rows(blocks, lengths, mesh, cfg)
    return fmt.varint_encode(n) + payload


# ---- decode ----

def _decode_local(mesh: meshlib.Mesh, arrays: tuple, wave: int, decode):
    """decode(*wave_arrays) -> (out, ok[, rounds]) over this process's
    shards, wave by wave; the outputs of every shard of every process
    gathered in row order. Returns (out (R, 65536) uint8, ok (R,) bool,
    this process's rounds a wave)."""
    outs, oks, rounds = [], [], []
    for part in _on_shards(mesh, arrays):
        with _current(part[0].device):
            for s in range(0, part[0].shape[0], wave):
                res = decode(*(a[s:s + wave] for a in part))
                outs.append(res[0].cpu().numpy())
                oks.append(res[1].cpu().numpy())
                if len(res) > 2:
                    rounds.append(res[2])
    return (fetch_global(np.concatenate(outs), mesh),
            fetch_global(np.concatenate(oks), mesh), rounds)


def decode_sharded(mesh: meshlib.Mesh, frags, clens, ulens, wave: int):
    """The fragment decoder (decode_fragments, "tiledtail") sharded: a
    padded batch (rows a multiple of mesh.size * wave). Returns (out, ok,
    dense rounds of this process's waves)."""
    return _decode_local(mesh, (frags, clens, ulens), wave,
                         ops_decode.decode_fragments)


def decode_depth_sharded(mesh: meshlib.Mesh, frags, clens, ulens, depths,
                         wave: int):
    """The depth-hinted decoder (framing 0x81 chunks) sharded; as
    decode_sharded."""
    return _decode_local(mesh, (frags, clens, ulens, depths), wave,
                         ops_decode.decode_fragments_depth)


def decode_sidecar_sharded(mesh: meshlib.Mesh, elems, starts, vals, ulens,
                           wave: int, wrows: int | None = None):
    """The root-map decode (framing 0x80 chunks, sidecar.decode_chunks at
    one `wrows` bucket) sharded. Returns (out, ok, [])."""
    return _decode_local(
        mesh, (elems, starts, vals, ulens), wave,
        lambda e, s, v, u: sc.decode_chunks(e, s, v, u, wrows))


def decode_dp(comp: bytes, mesh: meshlib.Mesh,
              cfg: CodecConfig = DEFAULT_CONFIG) -> bytes:
    """Fragment-parallel decompression sharded over `mesh`. Fragments that
    fail the device's checks re-decode on the host with the decoded prefix
    as context (api._splice_failed_fragments); a corrupt stream raises
    ValueError. `cfg` is the JAX package's argument (shard.py:222),
    checked and, as there, unused: no decode depends on it."""
    if not isinstance(cfg, CodecConfig):
        raise TypeError(f"cfg: expected a CodecConfig, got {cfg!r}")
    total, start = fmt.varint_decode(comp)
    if total == 0:
        return b""
    frags, clens, ulens = ops_decode.fragment_table(comp, start, total)
    frags = frags[:, : ops_decode.frag_width(clens)]
    nfrag = len(clens)
    wave, padded = layout(nfrag, mesh.size)
    fr = np.pad(frags, ((0, padded - nfrag), (0, 0)))
    cl = np.pad(clens, (0, padded - nfrag)).astype(np.int32)
    ul = np.pad(ulens, (0, padded - nfrag)).astype(np.int32)
    out, ok, _ = decode_sharded(mesh, fr, cl, ul, wave)
    out, okv = out[:nfrag], ok[:nfrag]
    if not okv.all():
        result = api._splice_failed_fragments(frags, clens, ulens, out, okv)
    else:
        result = b"".join(out[i, : ulens[i]].tobytes()
                          for i in range(nfrag))
    if len(result) != total:
        raise ValueError("length mismatch vs preamble")
    return result
