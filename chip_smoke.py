#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpu_snappy_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--parent DIR]

With --parent DIR (a checkout of an earlier commit, for example unpacked
with `git archive` into a git-ignored directory), phase 9 also times that
checkout's kernels named in REDESIGNED (the two matchers, the two
emissions, the three tiled resolves, doubling_round, place_block, the
windowed scatter, resolve_block, next_start_block, ffill and
local_round) beside this one's
on every captured call, in turns (their outputs must be equal, every
tensor; the matchers' calls above K 24, which the parent refuses, this
checkout's alone), with each turn's bound share and library ratio, the tiled
resolves, doubling_round, place_block and resolve_block also on each
call's first 8 rows, the tiled resolves and resolve_block on the period-1
chain, next_start_block at M 384, 57344, 65536 and 69632 (128 rows and
1-D), times phase 7's "flagtail" decode_corpus through both trees, and
sweeps the tiles of the two scatters and of place_block's
windowed scatter, ffill's chunk, and every tile of the five tiled kernels
(SWEPT: resolve_tiled, resolve_tiled_dual, resolve_tiled_depth,
resolve_tiled_flag and local_round, each on its captured call, all but
resolve_tiled_dual in turns with the parent's).

Phases, each printing its results; any failure raises (non-zero exit):

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel compiled from ops/kernels/csrc/ with nvcc (one
   process per source file, all started together);
3. kernel against plain: each of the twenty-three kernels equals its plain
   PyTorch version exactly (all integer, drop counts included) on random
   inputs and edge cases at the main path's shapes (the matchers at K 3,
   8, 14 and 15, sticky "exact" and "sig", stride 1 and 2, and on a row
   planted with signature collisions, and on rows at their tile edges at
   K 2, 3, 8, 14, 15, 16, 17, 18 and 24, both sticky modes, lazy 0, 1
   and 2: ties in
   the propagation window, copies at every halo and tile edge, n at a tile
   boundary and one past; the wide matcher kernel (K past FIXED_K) at
   every K from 25 to 33 and at 40, 48, 64 and 96 (96 on two rows a
   table) on the same rows, the collision row and random small-offset
   tables, both forms, both sticky modes, lazy 0 and 2, each call
   launching; the emissions on real and synthetic parses and
   on parses at their tile edges: a 65536-byte literal run,
   runs of 60, 61, 256 and 257 on tile boundaries, 3-byte copies whose
   header bytes cross one, n inside a run, an all-copy row, a
   block-opening literal; resolve_tiled, resolve_tiled_dual,
   resolve_tiled_depth, resolve_tiled_flag and local_round at every tile
   they take (128 to 65536) on tests/torch_edges.py's tiled-resolve rows
   at 1, 8, 128 and 133 rows under every `resolved` flag (check 1 and 3,
   every variant), declared depth kind (0, under, over, above the cap,
   negative) and root-flag kind (exact, over, zero, under), an illegal tile,
   check or variant refused; the resolve kernels on the JAX tests' maps,
   the period-1 chain and a depth-10000 chain among them, with exact,
   over-approximate, all-zero, under-approximate and all-one root flags and
   partly stable tiles, resolve_block also on the tiled-resolve rows at 1,
   8, 128 and 133 rows; the windowed gathers in chained rounds on the same
   maps; the element fields on random, all-zero and all-255 rows at three
   widths; resolve_tiled_dual with asymmetric `resolved` flags; the two
   prefix scans at four widths and 1-D, with int32-wrapping sums and
   next_start_block at default m, 0 and 100 on all-zero, first-only,
   last-only and all-set flags, and on tests/torch_edges.py's span-edge
   rows (one flag around each span and read-ahead end of the kernel, only
   at m - 1, none) batched and 1-D at default m, 0, 100 and m // 2;
   gather_block at limbs 1-3, tables of 256
   to 131072, out-of-range indices and x and idx one tensor; scatter_block
   at limbs 1-3, out_cells 128 to 67584, M up to 65536, every source on
   one cell and the top limb at 2^(8 limbs), at three tiles;
   scatter_windowed at wrows 1, 7, 40, 72, 136, 192 and 512 on piece
   starts padded at 65536, rows with no active or no kept dest, a source
   tile over three output tiles and random dests, at tiles 512 to 8192,
   and at limbs 1, 2 and 3 onto out_cells 32768, 65536 and 67584 at tiles
   512 to 16384; place_block (the windowed scatter at one limb) on the
   encoder's lanes and on torch_edges.place_edge_rows at 1, 8 and 128
   rows (non-monotone and duplicated dests, dests over the whole row and
   negative ones, the clamped last window, the partial last output tile,
   no kept write, two lanes restarting at the seam); doubling_round at
   B 1, 8 and 128 with pointers below 0 and at or past 65536 under zero,
   random and all-one flags;
   ffill at B 2, 126 and 128, widths 57344 and 65536, 1 to 4 payloads,
   masks set only at 0, only at m - 1, only at each chunk's last position,
   empty and full, at every chunk size, and with max_gap 1 to 4096; and
   with 5, 6, 8 and 9 payloads (a fill launch for each four) on those
   masks at B 2 and 128, every chunk, without max_gap and at 100 and
   1025); crc32c_rows (no TPU counterpart: the JAX package's CRC-32C
   runs on the host) at row lengths 0 to 65536 on both sides of every
   load and segment edge, with random, all-0xFF and all-zero bytes past
   each length, and at 1,100 rows of random lengths (clamped below 0 and
   past the row), also against framing.crc32c on the host;
4. round trip: 16 MiB of seeded mixed data through api.compress and
   api.decompress (resolve "tiledtail") on the card, checked against the
   host goldens, with the launch counters showing that the raw path ran
   every kernel it has (gather_block in at least one dense round a wave);
5. framed: the same 16 MiB through framing.compress with sidecar "off",
   "auto" and "always", each stream decoded by the C++ golden and by
   framing.decompress with and without its sidecars, with the chunks each
   decode path took, no hinted chunk re-decoded after a CRC miss, and the
   launch counters showing resolve_tiled_depth, the sidecar's 1-limb
   gather and one crc32c_rows a compress; compress / decompress GB/s per
   policy;
6. presets: the same 16 MiB through api.compress / api.decompress under
   FAST, TURBO, ULTRA and flatten "off", each stream checked against the
   host goldens and, on its first 4 blocks, against the port's CPU
   stream, with ratio, GB/s, peak memory, dense rounds and launch
   counters (the packed matcher at K=3 sig, matcher_block, the decode
   kernels); a framed sidecar "auto" round trip under ULTRA; then one
   wave through encode_blocks at every placement, each giving the bytes
   of "auto" (emit_block among the launches);
7. resolve modes: the DEFAULT stream of phase 4 through
   ops.decode.decode_corpus at the API's wave under "tiledtail", "tiled",
   "flagtail", "paratail", "kernel", "stable", "plain", "windowed",
   "hybrid" (with WINDOWED_OPENING off and on) and "auto", "tiledtail"
   with fields="kernel", and "kernel" and "stable" again without the run
   collapse, each giving the input bytes, all fragments ok, equal to
   "tiledtail"'s output, with its decode seconds, rounds per wave (and
   "hybrid"'s chase steps) and launch counters (each mode's own kernel
   among them);
8. times: raw compress / decompress throughput and peak device memory;
   compress's peak device memory at 16 MiB and 1 GiB (the same data 64
   times, its stream checked by the C++ golden), and the bytes of device
   memory per input byte between the two; then traced raw and framed
   round trips, a framed "auto" compress of the 16 MiB four times over
   (1,024 rows, the last short, as in the framed cell's 64 MiB call:
   crc32c_rows at its shape; checked by the C++ golden), plus FAST, TURBO and flatten "off" compresses (FAST for
   the packed matcher at K=8 "exact" among the captured calls) and
   compresses of the first WIDE_BLOCKS blocks at K 17 "exact" and K 18
   "sig" (the matchers above K 16) and at K 32 and 64, "exact" and "sig"
   (the wide kernel), each stream equal to the port's CPU stream and
   decoded by reference_codec, and of the first 128 blocks at K 32 and 64
   at both sticky modes and at K 32 with flatten "off" (the wide kernel
   at the API's wave), an "emit"
   and a "sort" placement wave and decode_corpus
   under "flagtail", "paratail", "kernel", "stable", "windowed", "hybrid"
   with the opening and fields="kernel", with a synchronised host clock
   around each public stage and kernel wrapper, which also capture every
   kernel's inputs and those of the commit and prefix scans; every
   entry-state form of commit_general and commit_bounded timed on the
   captured jumps (each form's flags equal to the default's); the 16 MiB
   decompressed with decode.PARSE_TREE_LEVELS 2 and 4 beside 0;
9. main path, kernel against plain: each kernel equals its plain version
   exactly on the calls captured from the main paths (the wave shapes they
   really run at), the time of both on them (CUDA events; for the kernel
   also graph_ms, the device time alone: 20 calls captured in one CUDA
   graph and replayed), the least time the card could take for the same
   work (for the matchers, at every K, the operations this run's table
   needs: torch_edges.matcher_ops), and the time (and graph_ms) of one PyTorch call
   computing the same function where there is one (for the scatters it
   allocates and zeroes its output, as the kernels must).
   resolve_tiled_dual, on no
   decode path, runs on the first two rows of the captured resolve_tiled
   call; cumsum_block and next_start_block, on no codec path, on the
   captured arguments of scan.exclusive_cumsum and
   scan.next_element_start, each also giving that stage's result;
   beside resolve_block's captured call, resolve_tiled (no `resolved`
   flags, the same function for src[p] <= p) on the same tensors, equal
   and timed; ffill on the captured mask of its call with the most
   payloads, also with 8 payloads (two fill launches), equal and timed.
   Host load averages print beside the times;
10. parallel and surfaces: the same 16 MiB through shard.encode_dp and
   decode_dp on a one-card mesh and on a mesh of four shards on cuda:0
   (also decoding the C++ golden's stream), streaming.compress_stream in
   4 waves of 64 blocks, and framing.compress / decompress /
   decompress_stream with the one-card mesh under each sidecar policy,
   each stream equal to phase 4's or 5's and each framed decode taking
   the same chunks down each path as phase 5's, with the launch counters
   (their own line) showing that the eleven kernels of the raw and framed
   paths ran under the sharded paths; then two processes on cuda:0 over
   gloo running multihost.compress_dp_global and compress_multihost
   (tests/torch_multiproc.py, with a timeout, workers reaped on failure),
   the compat and hadoop round trips, and the CLI (python -m
   tpu_snappy_torch) in six subprocesses started together (raw,
   --framed --sidecar auto, --hadoop, --mesh 1, --stream, --turbo), each
   output file equal to the API's bytes; GB/s of each sharded path;
11. server: the 16 MiB through serving.CodecServer on the card, 64
   slices of four blocks (the last takes the remainder) compressed raw
   and framed under each policy and 4 slices below one block compressed
   raw (the host fast path), submitted from 8 threads at once, then every
   stream decompressed, one corrupt stream among them (its future alone
   fails, with ValueError); at waves of 8 and of the API's 128, each at
   PIPELINE_DEPTH 1 and 2 (at 128 in turns, twice each), and on four
   shards of cuda:0;
   each stream equal to api.compress or framing.compress of its slice,
   each decode equal to its slice, every wave kind (encode, decode, root
   map, depth hints) dispatched; wall seconds and GB/s of each stage,
   ServerStats, depth 1 against depth 2, and the launch counters (their
   own line) showing the eleven kernels of the raw and framed paths.

The second-to-last lines are a JSON object of per-kernel results (its
`launches` count phases 4 to 7, each path run with the counters set to
0 just before it; `worst_library_ratio` is the largest graph_ms over the
library call's and `least_bound_share` the smallest bound over graph_ms,
over the kernel's captured calls; the other numbers are its largest
call's; the matchers' calls above FIXED_K give their own `wide_*` keys:
the largest such call's K, sticky, graph_ms and bound, and the least
bound share over them) and the nvidia-smi name/power line, after the run's
own seconds (from the start of main(), the build included); the last
line is
{"ok": true, "device": ...}.
Imports nothing of JAX and nothing of the JAX package (checked at the
end of the run).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# The seeded inputs (the round-trip data, the synthetic parses and the rows
# at the matcher's and the emission's tile edges), shared with the tests.
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_edges import (CORRUPT_STREAM, DEPTH_KINDS,  # noqa: E402
                         FLAG_KINDS, LIMB_WROWS, OUT_CELLS, PLACE_KINDS,
                         RESOLVED_KINDS, SEED, depth_variant,
                         emit_edge_parses, limb_rows, make_data,
                         matcher_edge_rows, matcher_ops, place_edge_rows,
                         next_start_edge_rows, resolved_flags, root_flags,
                         synthetic_parse, tiled_resolve_rows)

ROUND_TRIP_BYTES = 16 << 20
#: Copies of the round-trip data phase 8 compresses framed: 1,024 rows,
#: as in the framed cell's 64 MiB call (portbench's write mix).
FRAMED_COPIES = 4
BATCH = 8  # rows for the kernel-against-plain checks
N = 1 << 16

#: Device memory rate and integer rate of one H100 SXM at its full power
#: limit: 3.35 TB/s (NVIDIA's data sheet) and 64 INT32 lanes per SM x 132
#: SMs x 1.98 GHz boost clock (the Hopper architecture white paper).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9


def _card() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return torch.cuda.get_device_name(0), smi.splitlines()[0]


def _exact(a, b) -> int:
    """Largest |a - b| over two integer tensors of one shape."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernels(dev) -> None:
    """Phase 3: every kernel against its plain version, exact equality, on
    random inputs and the JAX tests' edge cases; raises on any
    difference."""
    from tpu_snappy_torch.ops.kernels import (ffill, gather, scatter,
                                              tiledres, windows)

    rng = np.random.default_rng(SEED)
    report = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # window_keys: random rows, n at every edge the JAX tests use.
    blocks = t(rng.integers(0, 256, (BATCH, N), dtype=np.uint8))
    n = t(np.array([N, N - 1, 5000, 4, 3, 0, N, 1234], np.int32))
    err = _exact(windows.window_keys(blocks, n),
                 windows.window_keys_plain(blocks, n))
    report["window_keys"] = err
    print(f"kernel window_keys  B={BATCH} n edges: max_abs_err={err}")

    # ffill: encode width and decode transport widths, 1-4 payloads,
    # sparse masks, leading unmasked runs, empty and full masks.
    errs = []
    for m in (N, 8192, 32768):
        mask = rng.random((BATCH, m)) < 0.03
        mask[1, :500] = False
        mask[2] = False
        mask[3] = True
        mask[4, :] = False
        mask[4, m - 1] = True
        for k in (1, 2, 3, 4):
            vals = tuple(t(rng.integers(-(1 << 20), 1 << 20, (BATCH, m),
                                        dtype=np.int32)) for _ in range(k))
            got = ffill.ffill(t(mask), vals)
            want = ffill.ffill_plain(t(mask), vals)
            errs += [_exact(g, w) for g, w in zip(got, want)]
        print(f"kernel ffill        B={BATCH} M={m} k=1..4: "
              f"max_abs_err={max(errs)}")
    errs += _ffill_edges(ffill, rng, t)
    errs += _ffill_gaps(ffill, rng, t)
    errs += _ffill_many(ffill, rng, t)
    report["ffill"] = max(errs)

    # scatter_windowed: transport-shaped dests (nondecreasing, dropped
    # writes, tag/payload cells summing in disjoint limbs), random dests
    # that overflow the window, and one overflow of count 1.
    errs = []
    for m in (8192, 32768):
        dest = np.minimum(np.cumsum(rng.integers(1, 3, (BATCH, m)), axis=1),
                          N).astype(np.int32)
        drop = rng.random((BATCH, m)) < 0.3
        d = np.where(drop, N, dest).astype(np.int32)
        vals = np.where(rng.random((BATCH, m)) < 0.5,
                        rng.integers(0, 1 << 16, (BATCH, m)) << 8,
                        rng.integers(0, 256, (BATCH, m))).astype(np.int32)
        cases = [(d, vals),
                 (rng.integers(0, N + 1, (BATCH, m), dtype=np.int32),
                  rng.integers(0, 1 << 24, (BATCH, m), dtype=np.int32))]
        for dd, vv in cases:
            got, govf = scatter.scatter_windowed(t(dd), t(vv))
            want, wovf = scatter.scatter_windowed_plain(t(dd), t(vv))
            errs += [_exact(got, want), _exact(govf, wovf)]
        print(f"kernel scatter_win  B={BATCH} M={m}: max_abs_err={max(errs)}"
              f" (random-dest overflow counts {wovf.tolist()})")
    d = np.full((BATCH, 1024), N, np.int32)
    d[:, 0], d[:, 1023] = 0, 40000
    got, govf = scatter.scatter_windowed(t(d), t(np.full_like(d, 5)))
    want, wovf = scatter.scatter_windowed_plain(t(d), t(np.full_like(d, 5)))
    errs += [_exact(got, want), _exact(govf, wovf)]
    if govf.tolist() != [1] * BATCH or int(got[0, 40000]) != 0:
        raise AssertionError(f"overflow not counted once: {govf.tolist()}")
    print(f"kernel scatter_win  overflow case: counts {govf.tolist()}, "
          f"max_abs_err={max(errs)}")
    errs += _scatter_windowed_edges(scatter, rng, t)
    errs += _scatter_windowed_limbs(scatter, t)
    report["scatter_windowed"] = max(errs)

    check_tiled_resolves(tiledres, t, report)

    # gather_block: limbs 1-3 (values up to 2^(8 limbs) - 1), tables of
    # 8192 to 131072 (and an odd width), T 4096 to 65536 (and 4093 and
    # 12285, the one-by-one loop) at B 1 to 64, out-of-range and negative
    # indices, and x and idx one tensor (the dense rounds).
    errs = []
    for limbs, s, tt, b in ((1, 8192, 4096, 3), (2, 16384, 12288, 1),
                            (3, N, 57344, 3), (1, N, N, BATCH),
                            (2, N, N, 1), (3, 8192, 4093, 3),
                            (2, 8190, 12288, 3), (2, 8190, 12285, 64),
                            (2, 131072, 12288, 3)):
        top = (1 << (8 * limbs)) - 1
        x = rng.integers(0, top + 1, (b, s)).astype(np.int32)
        x[:, :3] = top
        idx = rng.integers(-100, s + 100, (b, tt)).astype(np.int32)
        idx[:, :4] = (0, s - 1, -1, s)
        xt, it = t(x), t(idx)
        errs.append(_exact(gather.gather_block(xt, it, limbs),
                           gather.gather_block_plain(xt, it, limbs)))
    for limbs, s, b in ((2, N, BATCH), (3, N, 3), (1, 256, 1)):
        ptr = t(np.minimum(np.arange(s), rng.integers(0, s, (b, s)))
                .astype(np.int32))  # a map of back pointers, x is idx
        errs.append(_exact(gather.gather_block(ptr, ptr, limbs),
                           gather.gather_block_plain(ptr, ptr, limbs)))
    report["gather_block"] = max(errs)
    print(f"kernel gather_block limbs 1-3, S 256 to 131072, T 4093 to "
          f"65536, B 1 to 64, out-of-range indices, x is idx: "
          f"max_abs_err={max(errs)}")
    check_encode_kernels(dev, rng, t, report)
    check_resolve_kernels(rng, t, report)
    check_window_kernels(rng, t, report)
    check_scan_kernels(rng, t, report)
    check_crc_kernel(rng, t, report)
    if any(report.values()):
        raise AssertionError(f"kernel disagrees with plain: {report}")


#: Rows of phase 3's tiled-resolve checks: one, a server wave, an API
#: wave, and more rows than the card has SMs.
TILED_BATCHES = (1, 8, 128, 133)
#: resolve_tiled's `check` values phase 3 runs at every tile.
CHECKS = (1, 3)
#: The 8-row batch's pairs of rows resolve_tiled_dual runs on (the second
#: holds the period-1 chain).
DUAL_PAIRS = (0, 4)


def check_tiled_resolves(tiledres, t, report: dict) -> None:
    """Phase 3, the five tiled kernels at every tile they take
    (tiledres.TILES, 128 to 65536) against their plain versions on
    tests/torch_edges.py's tiled-resolve rows (every lane at 0, chains of
    tiles - 1 hops, the period-1 chain, the identity, random maps, ...) at
    TILED_BATCHES rows: resolve_tiled under every RESOLVED_KINDS flag
    (`resolved` on maps not at their fixed point among them), at check 1
    and 3 and every variant ("pair" refused at 65536); resolve_tiled_dual
    on two pairs of the 8-row batch under each flag and check;
    resolve_tiled_depth under every DEPTH_KINDS depth of the tile (exact,
    over- and under-declared, 0, above the cap, negative, mixed; the
    period-1 chain's exact depth is 10 in every 1024-tile);
    resolve_tiled_flag under every FLAG_KINDS flag; local_round. An
    illegal tile, check or variant must raise ValueError."""
    from tpu_snappy_torch.ops.kernels import localround

    errs = {k: [] for k in ("resolve_tiled", "resolve_tiled_dual",
                            "resolve_tiled_depth", "resolve_tiled_flag",
                            "local_round")}
    for batch in TILED_BATCHES:
        lit_np, src_np = tiled_resolve_rows(batch)
        lit, src = t(lit_np), t(src_np)
        flag_sets = {k: t(root_flags(k, src_np)) for k in FLAG_KINDS}
        for tile in tiledres.TILES:
            for kind in RESOLVED_KINDS:
                flags = resolved_flags(kind, batch)
                res = None if flags is None else t(flags)
                for check in CHECKS:
                    want = tiledres.resolve_tiled_plain(lit, src, res, tile,
                                                        check)
                    for variant in tiledres.VARIANTS:
                        if variant == "pair" and tile == N:
                            continue
                        errs["resolve_tiled"].append(_exact(
                            tiledres.resolve_tiled(lit, src, res, tile,
                                                   check, variant), want))
                    for row in DUAL_PAIRS if batch == 8 else ():
                        pair = (lit[row:row + 2].contiguous(),
                                src[row:row + 2].contiguous())
                        res2 = None if res is None else res[row:row + 2]
                        errs["resolve_tiled_dual"].append(_exact(
                            tiledres.resolve_tiled_dual(*pair, res2, tile,
                                                        check),
                            tiledres.resolve_tiled_dual_plain(
                                *pair, res2, tile, check)))
            exact = tiledres.tile_depths_plain(src, tile).cpu().numpy()
            if (tile == tiledres.DEPTH_TILE and batch > 5
                    and exact[5].tolist() != [10] * (N // tile)):
                raise AssertionError(f"chain depths {exact[5].tolist()}")
            for kind in DEPTH_KINDS:
                d = t(depth_variant(kind, exact))
                errs["resolve_tiled_depth"].append(_exact(
                    tiledres.resolve_tiled_depth(lit, src, d, tile),
                    tiledres.resolve_tiled_depth_plain(lit, src, d, tile)))
            for kind, f in flag_sets.items():
                errs["resolve_tiled_flag"].append(_exact(
                    tiledres.resolve_tiled_flag(lit, src, f, tile),
                    tiledres.resolve_tiled_flag_plain(lit, src, f, tile)))
            errs["local_round"].append(_exact(
                localround.local_round(src, tile),
                localround.local_round_plain(src, tile)))
    one = (t(tiled_resolve_rows(1)[0]), t(tiled_resolve_rows(1)[1]))
    refused = [lambda: tiledres.resolve_tiled(*one, None, N, 1, "pair"),
               lambda: tiledres.resolve_tiled(*one, None, 4096, 0),
               lambda: tiledres.resolve_tiled(*one, None, 4096, 1, "dual"),
               lambda: tiledres.resolve_tiled(*one, None, 2048 + 128),
               lambda: tiledres.resolve_tiled_flag(*one, one[1], 64),
               lambda: localround.local_round(one[1], 2 * N)]
    for call in refused:
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("an illegal tile, check or variant ran")
    for name, found in errs.items():
        report[name] = max(report.get(name, 0), max(found))
    print(f"kernel resolve_tiled B={TILED_BATCHES} tiles {tiledres.TILES} "
          f"(the tiled-resolve rows; resolved {', '.join(RESOLVED_KINDS)}; "
          f"check {CHECKS}; variants {tiledres.VARIANTS}): "
          f"max_abs_err={report['resolve_tiled']}")
    print(f"kernel resolve_tiled_dual (2, {N}) at every tile (pairs "
          f"{DUAL_PAIRS} of the 8-row batch; resolved "
          f"{', '.join(RESOLVED_KINDS)}; check {CHECKS}): "
          f"max_abs_err={report['resolve_tiled_dual']}")
    print(f"kernel resolve_depth B={TILED_BATCHES} at every tile (same "
          f"rows; depths {', '.join(DEPTH_KINDS)}): "
          f"max_abs_err={report['resolve_tiled_depth']}")
    print(f"kernel resolve_flag B={TILED_BATCHES} at every tile (same rows; "
          f"flags {', '.join(FLAG_KINDS)}): "
          f"max_abs_err={report['resolve_tiled_flag']}")
    print(f"kernel local_round B={TILED_BATCHES} at every tile (same rows): "
          f"max_abs_err={report['local_round']}; illegal tiles, check and "
          f"variant refused")


def _ffill_edge_masks(m: int) -> list:
    """Phase 3's fill masks at width m: set only at position 0, only at m
    - 1, only at the last position of each chunk (one row per chunk size
    the kernel takes), empty, full, and random at four densities."""
    from tpu_snappy_torch.ops.kernels import ffill

    rows = [np.zeros(m, bool) for _ in range(2)]
    rows[0][0] = True
    rows[1][m - 1] = True
    for chunk in ffill.CHUNKS:
        row = np.zeros(m, bool)
        row[chunk - 1::chunk] = True
        rows.append(row)
    rows += [np.zeros(m, bool), np.ones(m, bool)]
    rng = np.random.default_rng(SEED + m)
    rows += [rng.random(m) < p for p in (0.0005, 0.03, 0.3, 0.9)]
    return rows


def _ffill_edges(ffill, rng, t) -> list:
    """Phase 3, the fill at the main path's shapes: B 2, 126 and 128 at
    widths 57344 and 65536, 1 to 4 payloads, _ffill_edge_masks' rows (each
    in a call of its own pair at B 2), every chunk size at 1 and 4
    payloads. Returns the differences."""
    errs = []
    for m in (57344, N):
        edges = _ffill_edge_masks(m)
        for b in (2, 126, 128):
            if b == 2:
                masks = [np.stack([edges[i], edges[(i + 1) % len(edges)]])
                         for i in range(0, len(edges), 2)]
            else:
                mask = np.stack([edges[i % len(edges)] for i in range(b)])
                masks = [mask]
            for mask in masks:
                mk = t(mask)
                for k in (1, 2, 3, 4):
                    vals = tuple(t(rng.integers(-(1 << 31), (1 << 31) - 1,
                                                (b, m), dtype=np.int64)
                                   .astype(np.int32)) for _ in range(k))
                    want = ffill.ffill_plain(mk, vals)
                    chunks = ((None, *ffill.CHUNKS) if k in (1, 4)
                              else (None,))
                    for chunk in chunks:
                        got = ffill.ffill(mk, vals, chunk=chunk)
                        errs += [_exact(g, w) for g, w in zip(got, want)]
        print(f"kernel ffill        B 2/126/128 M={m} k=1..4, masks at 0 "
              f"only, m-1 only, each chunk's last position, empty, full, "
              f"random; chunks {ffill.CHUNKS}: max_abs_err={max(errs)}")
    return errs


#: The TPU fill's `max_gap` values phase 3 runs: windows of 2, 128, 1024
#: and 2048 (gap 1024 fills 1023 positions, 1025 one more) and the
#: sidecar's SPLIT_LEN.
FFILL_GAPS = (1, 2, 100, 1024, 1025, 4096)


def _ffill_gaps(ffill, rng, t) -> list:
    """Phase 3, the fill with the TPU kernel's `max_gap` (FFILL_GAPS) on
    _ffill_edge_masks' rows at B 2 (each pair of rows in a call) and 128,
    widths 57344 and 65536, 1 and 4 payloads, every chunk size: the masks'
    gaps lie below, at and above each window. Returns the differences."""
    errs = []
    for m in (57344, N):
        edges = _ffill_edge_masks(m)
        masks = [np.stack([edges[i], edges[(i + 1) % len(edges)]])
                 for i in range(0, len(edges), 2)]
        masks.append(np.stack([edges[i % len(edges)] for i in range(128)]))
        for mask in masks:
            mk, b = t(mask), mask.shape[0]
            for k in (1, 4):
                vals = tuple(t(rng.integers(-(1 << 31), (1 << 31) - 1,
                                            (b, m), dtype=np.int64)
                               .astype(np.int32)) for _ in range(k))
                for gap in FFILL_GAPS:
                    want = ffill.ffill_plain(mk, vals, gap)
                    for chunk in (None, *ffill.CHUNKS):
                        got = ffill.ffill(mk, vals, chunk=chunk, max_gap=gap)
                        errs += [_exact(g, w) for g, w in zip(got, want)]
    print(f"kernel ffill        max_gap {FFILL_GAPS} on the same masks, B "
          f"2/128, k 1 and 4, every chunk: max_abs_err={max(errs)}")
    return errs


#: Payload counts past one fill launch's four that phase 3 runs.
FFILL_MANY = (5, 6, 8, 9)


def _ffill_many(ffill, rng, t) -> list:
    """Phase 3, the fill with FFILL_MANY payloads (one fill launch for each
    four, sharing the first pass's indices) on _ffill_edge_masks' rows at
    B 2 (the first pair) and 128, widths 57344 and 65536, every chunk,
    without max_gap and at gaps 100 and 1025. Returns the differences."""
    errs = []
    for m in (57344, N):
        edges = _ffill_edge_masks(m)
        for mask in (np.stack(edges[:2]),
                     np.stack([edges[i % len(edges)] for i in range(128)])):
            mk, b = t(mask), mask.shape[0]
            for k in FFILL_MANY:
                vals = tuple(t(rng.integers(-(1 << 31), (1 << 31) - 1,
                                            (b, m), dtype=np.int64)
                               .astype(np.int32)) for _ in range(k))
                for gap in (None, 100, 1025):
                    want = ffill.ffill_plain(mk, vals, gap)
                    for chunk in (None, *ffill.CHUNKS):
                        got = ffill.ffill(mk, vals, chunk=chunk, max_gap=gap)
                        if len(got) != k:
                            raise AssertionError(f"ffill gave {len(got)} of "
                                                 f"{k} payloads")
                        errs += [_exact(g, w) for g, w in zip(got, want)]
    print(f"kernel ffill        {FFILL_MANY} payloads on the same masks, B "
          f"2/128, M 57344/65536, every chunk, max_gap none/100/1025: "
          f"max_abs_err={max(errs)}")
    return errs


def _piece_rows(rng, b: int, m: int, wrows: int) -> np.ndarray:
    """Sidecar-shaped piece starts: ascending with gaps that fit `wrows`
    (the widest a 1024-piece tile can span with its 8 rows of slop),
    padded with 65536 from a random length on."""
    step = max(1, (wrows - 9) * 128 // 1024)
    rows = np.minimum(np.cumsum(rng.integers(1, step + 1, (b, m)), axis=1),
                      N)
    for r in range(b):
        rows[r, rng.integers(m // 4, m + 1):] = N
    return rows.astype(np.int32)


def _scatter_windowed_edges(scatter, rng, t) -> list:
    """Phase 3, the windowed scatter at the sidecar's and the transport's
    window heights: piece starts padded at 65536 at wrows 40, 72, 136, 192
    and 512 (B 2, 8 and 128); beside them a row of only padding and
    out-of-range dests, a row whose every active dest the window drops
    (wrows 1 and 7), a source tile whose kept dests straddle three output
    tiles, and random dests at wrows 512 (every source tile meets every
    output tile); each at the wrapper's tile and at every tile from 512 to
    8192 cells. Returns the differences."""
    errs = []
    for wrows in (40, 72, 136, 192, 512):
        for b, m in ((2, 4096), (8, 32768), (128, 28672)):
            d = _piece_rows(rng, b, m, wrows)
            d[0] = np.where(np.arange(m) % 3 == 0, -7, N + 5)  # no active
            if b > 2:
                # One tile's kept dests straddle three output tiles; the
                # next row's first tile overflows its window.
                d[1, :1024] = 100 + np.arange(1024) * (
                    min(wrows - 9, 80) * 128 // 1024)
                d[1, 1024:] = np.maximum(d[1, 1024:], d[1, 1023])
                d[2, :1024] = np.minimum(
                    np.arange(1024) * (wrows * 128 // 1024 + 16), N - 1)
                d[2, 1024:] = np.maximum(d[2, 1024:], d[2, 1023])
            v = rng.integers(0, 1 << 24, (b, m)).astype(np.int32)
            v[:, ::7] = -1  # the top limb unmasked: -1 >> 16 == -1
            dt, vt = t(d), t(v)
            want, wovf = scatter.scatter_windowed_plain(dt, vt, wrows)
            for tile in (None, 512, 1024, 2048, 4096, 8192):
                got, govf = scatter.scatter_windowed(dt, vt, wrows, tile)
                errs += [_exact(got, want), _exact(govf, wovf)]
        print(f"kernel scatter_win  wrows={wrows} piece starts (B 2/8/128, "
              f"padding, a row with no active dest, a tile over three "
              f"output tiles, an overflowing tile), tiles 512-8192: "
              f"max_abs_err={max(errs)} (drops {wovf.tolist()[:4]})")
    for wrows in (1, 7):
        # Each tile's least dest sits at 128 past its window base: wrows
        # 1 drops every active dest, wrows 7 those 7 rows further.
        d = np.tile(128 + np.arange(1024, dtype=np.int32) * 8, (2, 4))
        d[:, 1024:] += np.arange(1, 4).repeat(1024)[None, :] * 8192
        dt, vt = t(d), t(np.full_like(d, 3))
        want, wovf = scatter.scatter_windowed_plain(dt, vt, wrows)
        got, govf = scatter.scatter_windowed(dt, vt, wrows)
        errs += [_exact(got, want), _exact(govf, wovf)]
        if wrows == 1 and (wovf.tolist() != [4096, 4096] or want.any()):
            raise AssertionError(f"wrows 1 kept a write: {wovf.tolist()}")
    d = rng.integers(-5, N + 5, (128, 32768)).astype(np.int32)
    dt, vt = t(d), t(rng.integers(0, 1 << 24, d.shape).astype(np.int32))
    want, wovf = scatter.scatter_windowed_plain(dt, vt, 512)
    got, govf = scatter.scatter_windowed(dt, vt, 512)
    errs += [_exact(got, want), _exact(govf, wovf)]
    print(f"kernel scatter_win  every active dest dropped (wrows 1, 7), "
          f"random dests (128, 32768) at wrows 512: max_abs_err={max(errs)}")
    return errs


def _scatter_windowed_limbs(scatter, t) -> list:
    """Phase 3, the windowed scatter at limbs 1, 2 and 3 onto out_cells
    32768, 65536 and 67584 (torch_edges.limb_rows: near-monotone rows
    with drops and summed pairs, random dests that overflow, a tile over
    its window and tiles in the clamped last window), at 3 rows and tiled
    to 128, at the rule's tile and at tiles of 512 to 16384 cells. Returns
    the differences."""
    errs = []
    for limbs in (1, 2, 3):
        wrows = LIMB_WROWS[limbs]
        for cells in OUT_CELLS:
            d, v = limb_rows(limbs, cells)
            for dd, vv in ((d, v), (np.tile(d, (43, 1))[:128],
                                    np.tile(v, (43, 1))[:128])):
                dt, vt = t(dd), t(vv)
                want = scatter.scatter_windowed_plain(
                    dt, vt, wrows, limbs=limbs, out_cells=cells)
                for tile in (None, 512, 2048, 4096, 8192, 16384):
                    got = scatter.scatter_windowed(
                        dt, vt, wrows, tile, limbs=limbs, out_cells=cells)
                    errs += [_exact(g, w) for g, w in zip(got, want)]
            print(f"kernel scatter_win  limbs={limbs} out_cells={cells} "
                  f"wrows={wrows} (near-monotone, overflowing, clamped; B 3 "
                  f"and 128; tiles 512-16384): max_abs_err={max(errs)} "
                  f"(drops {want[1].tolist()[:3]})")
    return errs


def _matcher_rows(rng):
    """Phase 3's encoder rows: a full row whose last 68 bytes repeat its
    first 68 (the matcher's wrap), period-17 text, an `ab` ladder with
    random bytes, random bytes and seeded word text, at n = N, N-1, 5000,
    4, 3, 0, N, N. Returns (blocks (8, N) uint8, n (8,) int32)."""
    rand = rng.integers(0, 256, N, dtype=np.uint8)
    wrap = rng.integers(0, 256, N, dtype=np.uint8)
    wrap[-68:] = wrap[:68]
    text17 = np.frombuffer((b"abcdefghijklmnopq" * (N // 17 + 1))[:N],
                           np.uint8)
    ab = np.frombuffer(b"ab" * 8000 + bytes(N - 16000), np.uint8).copy()
    ab[16000:20000] = rng.integers(0, 256, 4000, dtype=np.uint8)
    words = np.frombuffer(make_data(2 * N, SEED + 2)[:N], np.uint8)
    rows = [(wrap, N), (text17, N - 1), (ab, 5000), (rand, 4), (text17, 3),
            (ab, 0), (words, N), (rand, N)]
    blocks = np.zeros((len(rows), N), np.uint8)
    for i, (row, n) in enumerate(rows):
        blocks[i, :n] = row[:n]
    return blocks, np.array([n for _, n in rows], np.int32)


def _sig_collision_row(rng) -> np.ndarray:
    """A random row with planted signature collisions: at each planted p
    the window at p-4 occurs only a bytes back and the window at p only b
    bytes back, sig(a) == sig(b). At K=3 "sig" carries p-4's default a
    into p, where only the final exact verification drops it for b."""
    x = np.arange(1, 2048, dtype=np.uint64)
    bucket = ((x * 0x9E3779B1) & 0xFFFFFFFF) >> 27
    row = rng.integers(0, 256, N, dtype=np.uint8)
    for p in range(3000, 60000, 2500):
        members = x[bucket == rng.integers(0, 32)]
        a, b = int(members[1]), int(members[2])
        w1, w2, other = (rng.integers(0, 256, 4, dtype=np.uint8)
                         for _ in range(3))
        row[p - 4 - a:p - a], row[p - a:p - a + 4] = w1, other
        row[p - b:p - b + 4] = w2
        row[p - 4:p], row[p:p + 4] = w1, w2
    return row


#: The K phase 3 holds the wide matcher kernel to (every K past the fixed
#: instances' FIXED_K up to 33, then larger), and the one it runs on
#: fewer rows.
WIDE_KS = (25, 26, 27, 28, 29, 30, 31, 32, 33, 40, 48, 64, 96)
WIDE_FEW_ROWS_K = 96


def _wide_matchers(rng, t, rows, edge_rows, coll_rows) -> tuple:
    """Phase 3, the wide matcher kernel (K above matcher.FIXED_K): the
    packed tables of _matcher_rows', matcher_edge_rows' and the collision
    row's blocks, and random packed tables of small offsets, at each of
    WIDE_KS (at WIDE_FEW_ROWS_K two rows of each), sticky "exact" and
    "sig", lazy 0 and 2, both forms against the plain version; every call
    must launch. Returns the packed and unpacked differences."""
    from tpu_snappy_torch import config
    from tpu_snappy_torch.ops import encode
    from tpu_snappy_torch.ops.kernels import matcher

    errs, errs_u = [], []
    launches = (matcher.matcher_block_packed.launches,
                matcher.matcher_block.launches)
    calls = 0
    for k in WIDE_KS:
        cfg = dataclasses.replace(config.DEFAULT_CONFIG, candidates=k,
                                  probes=k)
        rows_k = 2 if k == WIDE_FEW_ROWS_K else None
        cases = []
        for b, m in (rows, edge_rows, coll_rows):
            b, m = b[:rows_k], m[:rows_k]
            cases.append((*encode._candidate_offsets(
                encode._window_keys(b, m), m, cfg), m))
        nb = rows_k or BATCH
        lo, hi = (rng.integers(0, 40, (nb, k // 2, N)) for _ in range(2))
        cases.append((t(rng.integers(0, 40, (nb, N)).astype(np.int32)),
                      t((lo | hi << 16).astype(np.int32)), rows[1][:nb]))
        for pr, wd, m in cases:
            cands = matcher.unpack_table(pr, wd, k).contiguous()
            for sticky in ("exact", "sig"):
                for lazy in (0, 2):
                    want = matcher.matcher_block_packed_plain(
                        pr, wd, m, k, lazy, sticky)
                    got = matcher.matcher_block_packed(pr, wd, m, k, lazy,
                                                       sticky)
                    errs += [_exact(g, w) for g, w in zip(got, want)]
                    got = matcher.matcher_block(cands, m, lazy, sticky)
                    errs_u += [_exact(g, w) for g, w in zip(got, want)]
                    calls += 1
    ran = (matcher.matcher_block_packed.launches - launches[0],
           matcher.matcher_block.launches - launches[1])
    if ran != (calls, calls):
        raise AssertionError(f"wide matcher: {ran} launches for {calls} "
                             f"calls of each form")
    print(f"kernel matcher      wide form, K {WIDE_KS} (K "
          f"{WIDE_FEW_ROWS_K} on 2 rows a table): the encoder rows, the "
          f"tile edges, the collision row, random small-offset tables; "
          f"sticky exact/sig, lazy 0/2; {calls} calls a form: packed "
          f"max_abs_err={max(errs)}, unpacked max_abs_err={max(errs_u)}")
    return errs, errs_u


def _wide_at_fixed_k(rows, coll_rows) -> list:
    """Phase 3, the wide matcher kernel where the instances run: through
    matcher._wide at every K from MIN_K to FIXED_K, on the encoder tables
    of _matcher_rows' blocks and of the collision row, both forms, sticky
    "exact" and "sig", lazy 0 and 2, against the plain version; every call
    must launch. Returns the differences."""
    from tpu_snappy_torch import config
    from tpu_snappy_torch.ops import encode
    from tpu_snappy_torch.ops.kernels import matcher

    errs = []
    before = matcher._wide.launches
    calls = 0
    t0 = time.perf_counter()
    for k in range(matcher.MIN_K, matcher.FIXED_K + 1):
        cfg = dataclasses.replace(config.DEFAULT_CONFIG, candidates=k,
                                  probes=k)
        for b, m in (rows, coll_rows):
            pr, wd = encode._candidate_offsets(encode._window_keys(b, m), m,
                                               cfg)
            cands = matcher.unpack_table(pr, wd, k).contiguous()
            for sticky in ("exact", "sig"):
                for lazy in (0, 2):
                    want = matcher.matcher_block_packed_plain(
                        pr, wd, m, k, lazy, sticky)
                    for table in ((pr, wd), (cands,)):
                        got = matcher._wide(table, m, k, lazy, sticky)
                        errs += [_exact(g, w) for g, w in zip(got, want)]
                        calls += 1
    if matcher._wide.launches - before != calls:
        raise AssertionError(f"matcher._wide: "
                             f"{matcher._wide.launches - before} launches "
                             f"for {calls} calls")
    print(f"kernel matcher      wide form at the instances' K "
          f"{matcher.MIN_K}-{matcher.FIXED_K} (matcher._wide): the encoder "
          f"rows and the collision row, packed and unpacked, sticky "
          f"exact/sig, lazy 0/2; {calls} calls, all launched: "
          f"max_abs_err={max(errs)} ({time.perf_counter() - t0} s)")
    return errs


def check_encode_kernels(dev, rng, t, report: dict) -> None:
    """Phase 3, the encoder's kernels: both matchers, both emissions,
    placement and overflow scatter against their plain versions."""
    from tpu_snappy_torch import config
    from tpu_snappy_torch.ops import encode, scan
    from tpu_snappy_torch.ops.kernels import emit, matcher, place, scatter

    # matcher: the port's packed tables of the edge rows and of the
    # collision row at K 3, 8, 14 and 15 (stride 1, and the stride-2
    # expanded form), and random packed tables of small offsets (sticky
    # memberships hit often), each at sticky "exact" and "sig", lazy 2 and
    # 0; matcher_block on the unpacked form of every table.
    blocks_np, n_np = _matcher_rows(rng)
    blocks, n = t(blocks_np), t(n_np)
    coll = t(_sig_collision_row(rng)[None])
    coll_n = t(np.array([N], np.int32))
    cases = []
    for k in (3, 8, 14, 15):
        for stride in (1, 2):
            cfg = dataclasses.replace(config.DEFAULT_CONFIG, candidates=k,
                                      probes=k, stride=stride)
            for b, m in ((blocks, n), (coll, coll_n)):
                key = (encode._window_keys(b, m) if stride == 1
                       else encode._window_keys_strided(b, m, stride))
                cases.append((*encode._candidate_offsets(key, m, cfg), m, k))
        rp = rng.integers(0, 40, (BATCH, N)).astype(np.int32)
        lo = rng.integers(0, 40, (BATCH, k // 2, N))
        hi = rng.integers(0, 40, (BATCH, k // 2, N))
        cases.append((t(rp), t((lo | hi << 16).astype(np.int32)), n, k))
    errs, errs_u = [], []
    for pr, wd, m, k in cases:
        cands = matcher.unpack_table(pr, wd, k).contiguous()
        for sticky in ("exact", "sig"):
            for lazy in (2, 0):
                want = matcher.matcher_block_packed_plain(pr, wd, m, k, lazy,
                                                          sticky)
                got = matcher.matcher_block_packed(pr, wd, m, k, lazy, sticky)
                errs += [_exact(g, w) for g, w in zip(got, want)]
                got = matcher.matcher_block(cands, m, lazy, sticky)
                errs_u += [_exact(g, w) for g, w in zip(got, want)]
    print(f"kernel matcher      B={BATCH} (wrap row, period 17, ab ladder, "
          f"random, text; n edges; the collision row; K 3/8/14/15, stride "
          f"1/2, random tables; sticky exact/sig, lazy 2/0): packed "
          f"max_abs_err={max(errs)}, unpacked max_abs_err={max(errs_u)}")
    # The tile edges of the matcher kernel: ties in the propagation window,
    # copies at every halo and tile edge, n at a tile boundary and one past,
    # at K 2, 3, 8, 14, 15, 16, 17, 18 and 24 (above 16: the K 17-24
    # instances), both sticky modes, lazy 0, 1 and 2.
    eb, en = (t(x) for x in matcher_edge_rows())
    for k in (2, 3, 8, 14, 15, 16, 17, 18, 24):
        cfg = dataclasses.replace(config.DEFAULT_CONFIG, candidates=k,
                                  probes=k)
        pr, wd = encode._candidate_offsets(encode._window_keys(eb, en), en,
                                           cfg)
        cands = matcher.unpack_table(pr, wd, k).contiguous()
        for sticky in ("exact", "sig"):
            for lazy in (0, 1, 2):
                want = matcher.matcher_block_packed_plain(pr, wd, en, k, lazy,
                                                          sticky)
                got = matcher.matcher_block_packed(pr, wd, en, k, lazy,
                                                   sticky)
                errs += [_exact(g, w) for g, w in zip(got, want)]
                got = matcher.matcher_block(cands, en, lazy, sticky)
                errs_u += [_exact(g, w) for g, w in zip(got, want)]
    print(f"kernel matcher      tile edges B={len(en)} (ties, copies at the "
          f"halo and tile edges, n at and past a tile boundary; K 2/3/8/14/"
          f"15/16/17/18/24, sticky exact/sig, lazy 0/1/2): packed "
          f"max_abs_err={max(errs)}, unpacked max_abs_err={max(errs_u)}")
    wide, wide_u = _wide_matchers(rng, t, (blocks, n), (eb, en),
                                  (coll, coll_n))
    fixed = _wide_at_fixed_k((blocks, n), (coll, coll_n))
    report["matcher_block_packed"] = max(errs + wide + fixed)
    report["matcher_block"] = max(errs_u + wide_u + fixed)

    # emit: the committed parses of those rows, and synthetic parses with
    # long literal runs, far copies and a block-opening literal, through
    # both emission kernels.
    dflt = config.DEFAULT_CONFIG
    pref, words = encode._candidate_offsets(encode._window_keys(blocks, n), n)
    jump, off = matcher.matcher_block_packed(pref, words, n, dflt.candidates,
                                             dflt.lazy)
    iota = torch.arange(N, device=dev)
    cj = torch.where(scan.commit_bounded(jump) & (iota < n[:, None]),
                     jump, -1)
    syn_n = [N, N - 1, 1000, 300]
    syn = [synthetic_parse(rng, m) for m in syn_n]
    cj_s = t(np.stack([c for c, _ in syn]))
    off_s = t(np.stack([o for _, o in syn]))
    blk_s = t(rng.integers(0, 256, (len(syn), N), dtype=np.uint8))
    edges = tuple(t(x) for x in emit_edge_parses())
    for name in ("emit_block_single", "emit_block"):
        errs = []
        for args in ((cj, off, blocks, n),
                     (cj_s, off_s, blk_s, t(np.array(syn_n, np.int32))),
                     edges):
            want = getattr(emit, name + "_plain")(*args)
            got = getattr(emit, name)(*args)
            errs += [_exact(g, w) for g, w in zip(got, want)]
        report[name] = max(errs)
        print(f"kernel {name:18s} B={BATCH}+{len(syn)}+{len(edges[3])} (real "
              f"and synthetic parses, runs > 60 and > 256; tile edges: a "
              f"65536-byte run, runs of 60/61/256/257 on boundaries, 3-byte "
              f"copies across them, n inside a run, all copies, a "
              f"block-opening literal): max_abs_err={max(errs)}")

    # place: the encoder's main lanes, plus one tile that breaks the window
    # contract (counted once and dropped).
    pm = emit.emit_block_single(cj, off, blocks, n)[0]
    dest, vals = (pm >> 8).contiguous(), (pm & 0xFF).contiguous()
    dest[-1] = emit.SENT
    dest[-1, 0], dest[-1, 1023] = 0, 40000
    cap = dflt.block_capacity
    rows = cap // 128
    got, govf = place.place_block(dest, vals, rows)
    want, wovf = place.place_block_plain(dest, vals, rows)
    err = max(_exact(got, want), _exact(govf, wovf))
    if govf.tolist() != [0] * (BATCH - 1) + [1] or int(got[-1, 40000]):
        raise AssertionError(f"place_block window count {govf.tolist()}")
    print(f"kernel place        B={BATCH} (encoder lanes, one broken tile): "
          f"max_abs_err={err}, ovf {govf.tolist()}")
    # place_block's adversarial rows (torch_edges.place_edge_rows, the
    # PLACE_KINDS cycled over the rows): non-monotone tiles, summed
    # duplicates, random dests over the row and past its ends (negatives
    # among them), tiles in the clamped last window and the partial last
    # output tile, a row with no kept write, two lanes restarting at the
    # seam; 1, 8 and 128 rows of 65536 sources and 8 of 131072, onto 528
    # and 40 output rows.
    errs = [err]
    for b, m in ((1, N), (8, N), (128, N), (8, 2 * N)):
        d, v = place_edge_rows(b, m)
        for out_rows in (rows, 40):
            dt = t(np.minimum(d, out_rows * 128 + 5))
            vt = t(v)
            got, govf = place.place_block(dt, vt, out_rows)
            want, wovf = place.place_block_plain(dt, vt, out_rows)
            errs += [_exact(got, want), _exact(govf, wovf)]
    report["place_block"] = max(errs)
    print(f"kernel place        edge rows {PLACE_KINDS} at B 1/8/128 (M "
          f"65536) and B 8 (M 131072), out_rows {rows} and 40: "
          f"max_abs_err={max(errs)} (drops {wovf.tolist()})")

    # scatter_block: limbs 1-3, out_cells 128 to 67584, M 1024 to 65536,
    # drops at out_cells and below 0, summed duplicates, every source on
    # one cell (colliding atomics), the top limb at 2^(8 limbs); the
    # encoder's tile and tiles of one and of 128 cells.
    errs = []
    for limbs, cells, m, b in ((1, cap, 2048, BATCH), (2, N, 2048, BATCH),
                               (3, N, 1024, 3), (1, 128, 2048, 3),
                               (2, 128, 65536, 1), (3, N, 65536, 1),
                               (1, N, 65536, 1)):
        d = rng.integers(-50, cells + 50, (b, m)).astype(np.int32)
        d[:, :64] = cells
        d[:, 64:128] = -1
        d[:, 128:512] = rng.integers(0, 16, (b, 384))  # duplicates
        v = rng.integers(0, 1 << (8 * limbs), (b, m)).astype(np.int32)
        v[:, :256] = 1 << (8 * limbs)
        cases = [(d, v), (np.full_like(d, cells - 1), v)]
        for dd, vv in cases:
            want = scatter.scatter_block_plain(t(dd), t(vv), limbs, cells)
            for tile in (None, cells, 128):
                if tile and tile * limbs * 4 > scatter._build.SMEM_BYTES:
                    continue
                errs.append(_exact(scatter.scatter_block(
                    t(dd), t(vv), limbs, cells, tile), want))
    report["scatter_block"] = max(errs)
    print(f"kernel scatter_block limbs 1-3, out_cells 128/65536/67584, M "
          f"1024/2048/65536 (drops, duplicates, one cell, top limb 2^(8 "
          f"limbs); tiles by rule, whole row, 128): max_abs_err={max(errs)}")


def _resolve_maps(rng) -> np.ndarray:
    """Phase 3's maps for the resolve kernels, all with src[p] <= p: random
    back hops, tile straddles, the period-1 chain, the identity, the JAX
    tests' random hops around a depth-10000 chain
    (tests/test_pallas.py:162), random decreasing hops, sparse 7-hops and
    hops of one 4096-tile. Returns (8, N) int32."""
    ident = np.arange(N, dtype=np.int32)
    mixed = ident.copy()
    copies = rng.choice(np.arange(1, N), 20000, replace=False)
    mixed[copies] = np.maximum(copies - rng.integers(1, 64, 20000), 0)
    mixed[40000:50000] = np.arange(40000, 50000) - 1
    return np.stack([
        np.maximum(ident - rng.integers(1, 300, N), 0),
        np.maximum(ident - ident % 4096 - 1, 0),
        np.maximum(ident - 1, 0),
        ident,
        mixed,
        np.minimum(ident, rng.integers(0, N, N)),
        np.where(rng.random(N) < 0.5, ident, np.maximum(ident - 7, 0)),
        np.maximum(ident - 4096, 0)]).astype(np.int32)


def check_resolve_kernels(rng, t, report: dict) -> None:
    """Phase 3, the resolve modes' kernels: local_round, doubling_round,
    resolve_block and resolve_tiled_flag against their plain versions."""
    from tpu_snappy_torch.ops.kernels import (doubling, localround, resolve,
                                              tiledres)

    src = t(_resolve_maps(rng))
    lit = t(rng.integers(0, 256, (BATCH, N), dtype=np.int32))

    # local_round: three chained rounds.
    errs, s = [], src
    for _ in range(3):
        got = localround.local_round(s)
        errs.append(_exact(got, localround.local_round_plain(s)))
        s = got
    report["local_round"] = max(errs + [report["local_round"]])
    print(f"kernel local_round  B={BATCH} (the maps, 3 chained rounds): "
          f"max_abs_err={max(errs)}")

    # doubling_round: from zero, random and all-stable flags, 17 chained
    # rounds (the period-1 chain turns stable in the 17th); then the maps
    # tiled to 128 rows with pointers below 0 and at or past 65536 (each
    # reads 0) at B 1, 8 and 128, three chained rounds from each kind of
    # flags.
    errs = []
    part = t((rng.random((BATCH, doubling.TILES)) < 0.4).astype(np.int32))
    for stable in (torch.zeros_like(part), part, torch.ones_like(part)):
        s = src
        for _ in range(17):
            got = doubling.doubling_round(s, stable)
            want = doubling.doubling_round_plain(s, stable)
            errs += [_exact(g, w) for g, w in zip(got, want)]
            s, stable = got
    wide = src.repeat(16, 1).cpu().numpy()
    outside = rng.random(wide.shape) < 0.05
    wide[outside] = rng.choice([-1, -7, -(1 << 31), N, N + 1, 70000,
                                (1 << 31) - 1], int(outside.sum()))
    wide[3, 2048:4096] = rng.integers(N, 1 << 20, 2048)  # two tiles out
    part = (rng.random((128, doubling.TILES)) < 0.4).astype(np.int32)
    for b in (1, BATCH, 128):
        for flags in (np.zeros_like(part), part, np.ones_like(part)):
            s, stable = t(wide[:b]), t(flags[:b])
            for _ in range(3):
                got = doubling.doubling_round(s, stable)
                want = doubling.doubling_round_plain(s, stable)
                errs += [_exact(g, w) for g, w in zip(got, want)]
                s, stable = got
    report["doubling_round"] = max(errs)
    print(f"kernel doubling_round B={BATCH} (flags zero, partly stable, all "
          f"stable; 17 chained rounds) and B 1/8/128 with pointers outside "
          f"[0, 65536) (3 chained rounds a kind of flags): "
          f"max_abs_err={max(errs)}")

    # resolve_block: against the plain version (synchronous doubling to
    # the fixed point), which the kernel's in-place doubling must meet, on
    # the maps and on the tiled-resolve rows at every TILED_BATCHES size.
    errs = [_exact(resolve.resolve_block(lit, src),
                   resolve.resolve_block_plain(lit, src))]
    for batch in TILED_BATCHES:
        tlit, tsrc = (t(a) for a in tiled_resolve_rows(batch))
        errs.append(_exact(resolve.resolve_block(tlit, tsrc),
                           resolve.resolve_block_plain(tlit, tsrc)))
    report["resolve_block"] = max(errs)
    print(f"kernel resolve_block B={BATCH} (the maps, depth 65535 and 10000 "
          f"chains) and B={TILED_BATCHES} (the tiled-resolve rows): "
          f"max_abs_err={max(errs)}")

    # resolve_tiled_flag: exact, over-approximate, all-zero,
    # under-approximate and all-one flags.
    hop = torch.gather(src, -1, src.long())
    exact = (hop == src).to(torch.int32)
    over = exact | t((rng.random((BATCH, N)) < 0.5).astype(np.int32))
    under = exact & t((np.random.default_rng(SEED + 12).random((BATCH, N))
                       < 0.5).astype(np.int32))
    errs = []
    for flags in (exact, over, torch.zeros_like(exact), under,
                  torch.ones_like(exact)):
        errs.append(_exact(tiledres.resolve_tiled_flag(lit, src, flags),
                           tiledres.resolve_tiled_flag_plain(lit, src,
                                                             flags)))
    report["resolve_tiled_flag"] = max(errs + [report["resolve_tiled_flag"]])
    print(f"kernel resolve_tiled_flag B={BATCH} (the maps; flags exact, over, "
          f"zero, under, one): max_abs_err={max(errs)}")


def check_window_kernels(rng, t, report: dict) -> None:
    """Phase 3, the last resolve modes' kernels: gather_window_block and
    gather_window_anchored in chained rounds on the resolve maps,
    elem_fields_block on random, all-zero and all-255 rows (every
    look-ahead wraps) at three fragment widths, and resolve_tiled_dual
    with asymmetric `resolved` flags."""
    from tpu_snappy_torch.ops.kernels import (fields, gatherw, gatherwin,
                                              tiledres)

    src = t(_resolve_maps(rng))
    errs = []
    for k in (8, 16):
        s = src
        for _ in range(4):
            got = gatherw.gather_window_block(s, s, k)
            errs.append(_exact(got, gatherw.gather_window_block_plain(s, s,
                                                                      k)))
            s = got
    report["gather_window_block"] = max(errs)
    print(f"kernel gather_window_block B={BATCH} (the maps from themselves, "
          f"k 8 and 16, 4 chained rounds each): max_abs_err={max(errs)}")

    errs, s = [], src
    for _ in range(2):
        got = gatherwin.gather_window_anchored(s, s)
        want = gatherwin.gather_window_anchored_plain(s, s)
        errs += [_exact(g, w) for g, w in zip(got, want)]
        s = got[0]
    report["gather_window_anchored"] = max(errs)
    print(f"kernel gather_window_anchored B={BATCH} (the maps, 2 chained "
          f"rounds; in-window share {float(got[1].float().mean())}): "
          f"max_abs_err={max(errs)}")

    errs = []
    for w in (8192, 57344, 69632):
        c = np.concatenate([
            rng.integers(0, 256, (BATCH - 2, w), dtype=np.uint8),
            np.zeros((1, w), np.uint8), np.full((1, w), 255, np.uint8)])
        got = fields.elem_fields_block(t(c))
        want = fields.elem_fields_block_plain(t(c))
        errs += [_exact(g, v) for g, v in zip(got, want)]
    report["elem_fields_block"] = max(errs)
    print(f"kernel elem_fields_block B={BATCH} W 8192/57344/69632 (random, "
          f"all-zero, all-255 rows): max_abs_err={max(errs)}")

    lit = t(rng.integers(0, 256, (2, N), dtype=np.int32))
    errs = []
    for pair in ((0, 4), (2, 1)):
        s2 = src[list(pair)].contiguous()
        for flags in (None, [True, False], [False, True]):
            res = None if flags is None else t(np.array(flags))
            errs.append(_exact(tiledres.resolve_tiled_dual(lit, s2, res),
                               tiledres.resolve_tiled_dual_plain(lit, s2,
                                                                 res)))
    report["resolve_tiled_dual"] = max(errs + [report["resolve_tiled_dual"]])
    print(f"kernel resolve_tiled_dual (2, {N}) (pairs of the maps; resolved "
          f"none, [T, F], [F, T]): max_abs_err={max(errs)}")


def check_scan_kernels(rng, t, report: dict) -> None:
    """Phase 3, the two prefix scans: cumsum_block on B rows at four widths
    (384 is a multiple of 128 but not of the kernel's 4096 tile) and on
    1-D rows, with sums that wrap as int32; next_start_block at default
    m, 0 and 100 on random, all-zero, first-only, last-only and all-set
    flags."""
    from tpu_snappy_torch.ops.kernels import scans

    errs = []
    for m in (384, 57344, 65536, 69632):
        x = np.concatenate([
            rng.integers(0, 70, (BATCH - 3, m)),
            rng.integers(-(1 << 31), 1 << 31, (2, m)),
            np.full((1, m), 1 << 30)]).astype(np.int32)
        x = t(x)
        got = scans.cumsum_block(x)
        errs.append(_exact(got, scans.cumsum_block_plain(x)))
        errs.append(_exact(scans.cumsum_block(x[-1]),
                           scans.cumsum_block_plain(x[-1])))
        if int(got[-1, 1]) != -(1 << 31):
            raise AssertionError("cumsum_block does not wrap as int32")
    report["cumsum_block"] = max(errs)
    print(f"kernel cumsum_block B={BATCH} M 384/57344/65536/69632 and 1-D "
          f"(wrapping sums): max_abs_err={max(errs)}")

    errs = []
    for m in (384, 57344, 65536, 69632):
        f = rng.random((BATCH, m)) < 0.02
        f[1:5] = False
        f[2, 0] = True
        f[3, m - 1] = True
        f[4] = True
        f = t(f)
        for default in (m, 0, 100):
            errs.append(_exact(scans.next_start_block(f, default),
                               scans.next_start_block_plain(f, default)))
            errs.append(_exact(scans.next_start_block(f[4], default),
                               scans.next_start_block_plain(f[4], default)))
    # A single flag around each span and read-ahead end of the kernel,
    # only at m - 1, none: batched and each row 1-D.
    edge_errs = []
    for m in (384, 57344, 65536, 69632):
        f = t(next_start_edge_rows(m))
        for default in (m, 0, 100, m // 2):
            edge_errs.append(_exact(scans.next_start_block(f, default),
                                    scans.next_start_block_plain(f,
                                                                 default)))
            edge_errs += [_exact(scans.next_start_block(row, default),
                                 scans.next_start_block_plain(row, default))
                          for row in f]
    report["next_start_block"] = max(errs + edge_errs)
    print(f"kernel next_start_block B={BATCH} M 384/57344/65536/69632 and "
          f"1-D, default m/0/100 (random, all-zero, first-only, last-only, "
          f"all-set flags): max_abs_err={max(errs)}; on the span-edge rows "
          f"(batched and 1-D, default m/0/100/m//2): "
          f"max_abs_err={max(edge_errs)}")


#: Row lengths phase 3 runs crc32c_rows at: both sides of a byte, a word,
#: a 16-byte load, the plain version's 64-byte and the kernel's 256-byte
#: segment, a page and the row.
CRC_LENGTHS = (0, 1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 255, 256, 257, 4095,
               4096, 65535, 65536)


def check_crc_kernel(rng, t, report: dict) -> None:
    """Phase 3, continued: crc32c_rows against its plain version and
    framing.crc32c (the host's CRC-32C of each row's first n bytes) at
    every CRC_LENGTHS, with random, all-0xFF and all-zero bytes past each
    length; at 1,100 rows of random lengths, past the kernel's grid of
    1,056 CTAs; and on lengths below 0 and past the row (clamped)."""
    from tpu_snappy_torch import framing
    from tpu_snappy_torch.ops.kernels import crc

    errs = []
    for fill in ("random", "ones", "zeros"):
        rows = (rng.integers(0, 256, (len(CRC_LENGTHS), N), dtype=np.uint8)
                if fill == "random" else
                np.full((len(CRC_LENGTHS), N), 0xFF if fill == "ones" else 0,
                        np.uint8))
        for i, n in enumerate(CRC_LENGTHS):
            rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
        lengths = np.asarray(CRC_LENGTHS, np.int32)
        got = crc.crc32c_rows(t(rows), t(lengths))
        errs.append(_exact(got, crc.crc32c_rows_plain(t(rows), t(lengths))))
        host = [framing.crc32c(rows[i, :n].tobytes())
                for i, n in enumerate(CRC_LENGTHS)]
        errs.append(_exact(got.cpu(), torch.tensor(host)))
    rows = rng.integers(0, 256, (1100, N), dtype=np.uint8)
    lengths = rng.integers(0, N + 1, 1100).astype(np.int32)
    lengths[:3] = (-7, N + 5, N)
    got = crc.crc32c_rows(t(rows), t(lengths))
    errs.append(_exact(got, crc.crc32c_rows_plain(t(rows), t(lengths))))
    host = [framing.crc32c(rows[i, :min(max(int(n), 0), N)].tobytes())
            for i, n in enumerate(lengths)]
    errs.append(_exact(got.cpu(), torch.tensor(host)))
    report["crc32c_rows"] = max(errs)
    print(f"kernel crc32c_rows  B={len(CRC_LENGTHS)} lengths "
          f"{CRC_LENGTHS}, random / 0xFF / zero bytes past each; B=1100 "
          f"random lengths, clamped -7 and N+5: against plain and "
          f"framing.crc32c max_abs_err={max(errs)}")


def _kernel_modules() -> dict:
    """Every ported kernel: wrapper name -> module."""
    from tpu_snappy_torch.ops.kernels import (crc, doubling, emit, ffill,
                                              fields, gather, gatherw,
                                              gatherwin, localround,
                                              matcher, place, resolve,
                                              scans, scatter, tiledres,
                                              windows)
    return {"window_keys": windows, "ffill": ffill,
            "scatter_windowed": scatter, "resolve_tiled": tiledres,
            "matcher_block_packed": matcher, "emit_block_single": emit,
            "place_block": place, "scatter_block": scatter,
            "gather_block": gather, "resolve_tiled_depth": tiledres,
            "matcher_block": matcher, "emit_block": emit,
            "resolve_tiled_flag": tiledres, "local_round": localround,
            "resolve_block": resolve, "doubling_round": doubling,
            "gather_window_block": gatherw,
            "gather_window_anchored": gatherwin,
            "elem_fields_block": fields, "resolve_tiled_dual": tiledres,
            "cumsum_block": scans, "next_start_block": scans,
            "crc32c_rows": crc}


#: The kernel each resolve-mode run adds to the decode (phase 7), by
#: (resolve, fields, WINDOWED_OPENING).
MODE_KERNEL = {("flagtail", "auto", False): "resolve_tiled_flag",
               ("paratail", "auto", False): "local_round",
               ("kernel", "auto", False): "resolve_block",
               ("stable", "auto", False): "doubling_round",
               ("windowed", "auto", False): "gather_window_block",
               ("hybrid", "auto", True): "gather_window_anchored",
               ("tiledtail", "kernel", False): "elem_fields_block"}

#: Kernels on no codec path: held against their plain versions in phases
#: 3 and 9 only (the scans on the inputs the main paths hand to
#: scan.exclusive_cumsum and scan.next_element_start).
OFF_PATH = ("resolve_tiled_dual", "cumsum_block", "next_start_block")

#: Public stages whose inputs the traced run captures too: the scan forms
#: are timed on the captured jumps (phase 8) and the scan kernels run on
#: the captured scan inputs (phase 9).
CAPTURED_STAGES = ("commit_bounded", "commit_general", "exclusive_cumsum",
                   "next_element_start")

#: Kernels the raw DEFAULT round trip does not run: the framed sidecar
#: decodes', the framed encoder's CRC-32C, flatten "off"'s, the "emit"
#: placement's and the other resolve modes' and fields'.
NOT_RAW = ("resolve_tiled_depth", "crc32c_rows", "matcher_block",
           "emit_block", *MODE_KERNEL.values(), *OFF_PATH)


def _replaces(mod, name: str) -> str:
    """The TPU kernel a wrapper replaces; a module without REPLACES
    (crc.py) replaces none, the JAX package's work being on the host."""
    rep = getattr(mod, "REPLACES", None)
    if rep is None:
        return "none (host CRC-32C in the JAX package)"
    return rep[name] if isinstance(rep, dict) else rep


def _public_stages() -> dict:
    """The package's public stages on the main path: name -> (module,
    attribute). Each is reached through a module attribute at call time,
    so wrapping the attribute observes the real main path."""
    from tpu_snappy_torch import sidecar
    from tpu_snappy_torch.ops import decode, encode, scan
    return {"encode_blocks": (encode, "encode_blocks"),
            "_candidate_offsets": (encode, "_candidate_offsets"),
            "commit_bounded": (scan, "commit_bounded"),
            "_emit_winplace": (encode, "_emit_winplace"),
            "compact_blocks": (encode, "compact_blocks"),
            "decode_fragments": (decode, "decode_fragments"),
            "decode_fragments_depth": (decode, "decode_fragments_depth"),
            "parse_transport": (decode, "parse_transport"),
            "commit_general": (scan, "commit_general"),
            "exclusive_cumsum": (scan, "exclusive_cumsum"),
            "next_element_start": (scan, "next_element_start"),
            "dense_rounds": (decode, "dense_rounds"),
            "hybrid_rounds": (decode, "hybrid_rounds"),
            "sparse_chase": (decode, "sparse_chase"),
            "decode_corpus": (decode, "decode_corpus"),
            "decode_chunks": (sidecar, "decode_chunks")}


def _tensors(x) -> list:
    """The tensors in a kernel's arguments or results, flattened (scalar
    arguments such as K or lazy are skipped)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return _tensors(tuple(x.values()))
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _tensors(item)]
    return []


def _distinct(tensors: list) -> list:
    """The tensors with each storage once: the main path passes one tensor
    as two arguments (the dense rounds gather src from src)."""
    seen = {}
    for t in tensors:
        seen.setdefault((t.data_ptr(), t.numel() * t.element_size()), t)
    return list(seen.values())


def _clone(x, memo: dict | None = None):
    """A copy of a call's arguments that keeps their aliasing: a tensor
    passed twice is cloned once and passed twice."""
    memo = {} if memo is None else memo
    if isinstance(x, torch.Tensor):
        key = (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)
        if key not in memo:
            memo[key] = x.clone()
        return memo[key]
    if isinstance(x, dict):
        return {k: _clone(v, memo) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_clone(item, memo) for item in x)
    return x


def traced_round_trip(dev, data: bytes, framed: dict, corpus: tuple,
                      card: str):
    """Phase 8: one more raw round trip through the public API, the framed
    decodes of the "auto" and "always" streams, FAST, TURBO and flatten
    "off" compresses, one "emit" placement wave and decode_corpus of phase 7's
    fragments (`corpus`) under each resolve-mode run of MODE_KERNEL, with
    every public stage and every kernel wrapper wrapped in place. Each
    wrapped call is timed on the host clock between two synchronises, and
    the first call of each kernel per calling stage, input shape and
    scalar argument is cloned, so that phase 9 holds the kernel against
    its plain version on exactly the calls the main paths make. Returns
    those captured calls, each as (args, kwargs)."""
    from tpu_snappy_torch import api, config, framing
    from tpu_snappy_torch.ops import decode, encode

    kernels = _kernel_modules()
    blocks, lengths = api._to_blocks(data)
    wave = (torch.from_numpy(blocks[:api.API_WAVE]).to(dev),
            torch.from_numpy(lengths[:api.API_WAVE]).to(dev))
    targets = dict(_public_stages())
    targets.update({k: (mod, k) for k, mod in kernels.items()})
    clock = dict.fromkeys(targets, 0.0)
    calls = dict.fromkeys(targets, 0)
    stack, captured = [], {}

    def wrap(name, fn):
        # functools.wraps copies the `launches` attribute, which a wrapper
        # increments through its module global while it is replaced; the
        # counts of the main-path run were read before this phase.
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if name in kernels or name in CAPTURED_STAGES:
                scalars = tuple(a for a in (*args, *kwargs.values())
                                if isinstance(a, (int, str)))
                key = (name, stack[-1] if stack else "-",
                       tuple((tuple(t.shape), str(t.dtype))
                             for t in _tensors((args, kwargs))), scalars)
                if key not in captured:
                    captured[key] = _clone((args, kwargs))
            stack.append(name)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize(dev)
                clock[name] += (time.perf_counter() - t0) * 1e3
                calls[name] += 1
                stack.pop()
        return run

    saved = {name: getattr(mod, attr) for name, (mod, attr) in targets.items()}
    try:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, wrap(name, saved[name]))
        t0 = time.perf_counter()
        comp = api.compress(data, device="cuda")
        t1 = time.perf_counter()
        back = api.decompress(comp, device="cuda")
        t2 = time.perf_counter()
        backs = [framing.decompress(framed[p], device="cuda")
                 for p in ("auto", "always")]
        t3 = time.perf_counter()
        # 1,024 rows on one shard, as in the framed cell's 64 MiB call, so
        # crc32c_rows is captured at the shape the cell runs it at.
        framed_big = framing.compress(data * FRAMED_COPIES, sidecar="auto",
                                      device="cuda")
        t_big = time.perf_counter()
        api.compress(data, config.FAST_CONFIG, device="cuda")
        api.compress(data, config.TURBO_CONFIG, device="cuda")
        api.compress(data, _flat_off(), device="cuda")
        head = data[:WIDE_BLOCKS * len(blocks[0])]
        wide = [api.compress(head, cfg, device="cuda") for cfg in _wide_k()]
        wave_data = data[:api.API_WAVE * len(blocks[0])]
        wide_wave = [api.compress(wave_data, cfg, device="cuda")
                     for cfg in _wide_k(WIDE_WAVE)]
        encode.encode_blocks(*wave, placement="emit")
        encode.encode_blocks(*wave, placement="sort")
        t4 = time.perf_counter()
        modes = []
        for mode, fields, opening in MODE_KERNEL:
            decode.WINDOWED_OPENING = opening
            modes.append(decode.decode_corpus(*corpus, resolve=mode,
                                              fields=fields,
                                              wave=api.API_WAVE))
        t5 = time.perf_counter()
    finally:
        decode.WINDOWED_OPENING = False
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, saved[name])
    if back != data or any(b != data for b in backs):
        raise AssertionError("the traced round trip changed the data")
    if decode.native_golden().uncompress_framed(
            framed_big, max_out=len(data) * FRAMED_COPIES + 16) \
            != data * FRAMED_COPIES:
        raise AssertionError("the traced 1,024-block framed stream does "
                             "not decode under the C++ golden")
    if any(api.decompress(w, device="cuda") != head for w in wide):
        raise AssertionError("a stream above K 16 does not decode")
    if any(api.decompress(w, device="cuda") != wave_data
           for w in wide_wave):
        raise AssertionError("a stream at the API's wave above K 24 does "
                             "not decode")
    _wide_against_cpu(head, wide)
    if any(not torch.equal(out, modes[0][0]) for out, _ in modes):
        raise AssertionError("the traced resolve modes disagree")
    print(f"traced round trip (synchronised around every wrapped call), "
          f"compress {(t1 - t0) * 1e3} ms, decompress {(t2 - t1) * 1e3} ms,"
          f" framed decompress auto + always {(t3 - t2) * 1e3} ms, framed "
          f"compress \"auto\" of {len(data) * FRAMED_COPIES} bytes "
          f"{(t_big - t3) * 1e3} ms, FAST, "
          f"TURBO and flatten off compresses, {WIDE_BLOCKS} blocks at each "
          f"of {[(c.candidates, c.sticky) for c in _wide_k()]}, "
          f"{api.API_WAVE} blocks at each (K, sticky, flatten) of "
          f"{WIDE_WAVE} + an emit and a sort wave "
          f"{(t4 - t_big) * 1e3} ms, "
          f"decode_corpus under {list(MODE_KERNEL)} {(t5 - t4) * 1e3} ms; "
          f"host-clock ms per stage over all waves; load average "
          f"{os.getloadavg()} [{card}]:")
    for name in targets:
        print(f"  {name}: {clock[name]} ms in {calls[name]} calls")
    stages = {k: v for k, v in captured.items() if k[0] in CAPTURED_STAGES}
    return {k: v for k, v in captured.items() if k[0] in kernels}, stages


def _wide_against_cpu(head: bytes, streams: list) -> None:
    """Phase 8, continued: each traced compress of `head` above K 16
    equals the port's CPU stream at its config and decodes under
    reference_codec."""
    from tpu_snappy_torch import api, reference_codec
    for cfg, stream in zip(_wide_k(), streams):
        t0 = time.perf_counter()
        cpu = api.compress(head, cfg, device="cpu")
        seconds = time.perf_counter() - t0
        if stream != cpu:
            raise AssertionError(f"K {cfg.candidates} {cfg.sticky}: the "
                                 f"card's stream differs from the CPU's")
        if reference_codec.decompress(stream) != head:
            raise AssertionError(f"K {cfg.candidates} {cfg.sticky}: "
                                 f"reference_codec decodes another input")
        print(f"K {cfg.candidates} {cfg.sticky}, {WIDE_BLOCKS} blocks: "
              f"{len(stream)} bytes, the card's stream == the CPU's (CPU "
              f"compress {seconds} s), reference_codec decodes it")


def scan_forms(dev, stages: dict, card: str) -> None:
    """Phase 8, continued: every entry-state form of the two commit scans
    on the largest captured jumps (the decode parse's for commit_general,
    the encoder's for commit_bounded), host clock between synchronises,
    three repetitions each; every form's flags must equal the default's."""
    from tpu_snappy_torch.ops import scan

    runs = {"commit_general": [("sequential (default)", {}),
                               ("grouped", {"grouped": True})]
            + [(f"tree_levels={k}", {"tree_levels": k}) for k in range(1, 5)],
            "commit_bounded": [("log-depth (default)", {}),
                               ("sequential", {"sequential": True})]
            + [(f"tree_levels={k}", {"tree_levels": k}) for k in range(1, 5)]}
    for name, forms in runs.items():
        (jump,), _ = max((call for key, call in stages.items()
                          if key[0] == name),
                         key=lambda call: call[0][0].numel())
        fn = getattr(scan, name)
        want = None
        for label, kw in forms:
            ms = []
            for _ in range(3):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                flags = fn(jump, **kw)
                torch.cuda.synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            want = flags if want is None else want
            if not torch.equal(flags, want):
                raise AssertionError(f"{name} {label}: flags differ from "
                                     f"the default form's")
            print(f"scan form {name} {label} on {tuple(jump.shape)}: {ms} ms"
                  f" (3 runs), flags equal to the default's [{card}]")


def tree_decompress(data: bytes, comp: bytes, card: str) -> None:
    """Phase 8, continued: the 16 MiB through api.decompress with the
    parse's entry scan as the halving tree, decode.PARSE_TREE_LEVELS 2 and
    4, between two runs at 0 (the default, restored afterwards); each
    timed after a warm-up run."""
    from tpu_snappy_torch import api
    from tpu_snappy_torch.ops import decode

    try:
        for levels in (0, 2, 4, 0):
            decode.PARSE_TREE_LEVELS = levels
            api.decompress(comp, device="cuda")  # warm-up
            t0 = time.perf_counter()
            back = api.decompress(comp, device="cuda")
            seconds = time.perf_counter() - t0
            if back != data:
                raise AssertionError(f"PARSE_TREE_LEVELS={levels}: the "
                                     f"decompress changed the data")
            print(f"decompress with PARSE_TREE_LEVELS={levels}: {seconds} s"
                  f", {len(data) / seconds / 1e9} GB/s, the input's bytes; "
                  f"load average {os.getloadavg()} [{card}]")
    finally:
        decode.PARSE_TREE_LEVELS = 0


def _timed(fn, dev, reps: int) -> float:
    """Milliseconds per call: CUDA events over `reps` calls after a
    warm-up. A call costs the larger of its device time and its host
    cost (the wrapper's checks, allocations and launch)."""
    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps


#: Replays of a captured graph of `reps` calls that _graph_ms times.
GRAPH_REPLAYS = 5


def _graph_ms(fn, dev, reps: int = 20):
    """Device milliseconds per call, the host left out: `reps` calls
    captured in one CUDA graph (the wrapper's allocations go to the
    graph's pool, its launches to the capture stream through
    `_build.stream()`), replayed once to warm up, then GRAPH_REPLAYS
    replays timed with CUDA events. A call that cannot be captured (one
    that synchronises) gives "not capturable"."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:
        if "captur" not in str(exc).lower():
            raise
        torch.cuda.synchronize(dev)
        return "not capturable"
    graph.replay()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    stop.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(stop) / (GRAPH_REPLAYS * reps)
    del graph
    return ms


def _host_ms(fn, dev, reps: int = 200) -> float:
    """Host milliseconds per call: the host clock around `reps` calls with
    no synchronise between them (the wrapper's checks, allocations and
    launch; the card runs behind)."""
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    return seconds * 1e3 / reps


def _both(fn, dev) -> tuple:
    """(ms, graph_ms) of one call: wrapper included, and device only."""
    return _timed(fn, dev, 20), _graph_ms(fn, dev)


#: Integer operations per element that the function needs, for the
#: bound (elements: positions, or sources for the scatters); the matchers'
#: count is torch_edges.matcher_ops, on the call's own table. The others
#: do a few per element and are bound by bytes.
_OPS = {"window_keys": 8, "ffill": 3, "scatter_windowed": 12,
        "resolve_tiled": 2, "emit_block_single": 60, "place_block": 6,
        "scatter_block": 8, "gather_block": 3, "resolve_tiled_depth": 2,
        "emit_block": 60, "resolve_tiled_flag": 3, "local_round": 3,
        "doubling_round": 3, "gather_window_block": 5,
        "gather_window_anchored": 6, "elem_fields_block": 40,
        "resolve_tiled_dual": 2, "cumsum_block": 1, "next_start_block": 2,
        "crc32c_rows": 2}


def _doubling_rounds(src: torch.Tensor) -> int:
    """Synchronous doubling rounds that take the batch to its fixed point,
    the one that sees it included (at most 16): the passes resolve_block
    makes over this input."""
    s = src
    for r in range(1, 17):
        s2 = torch.gather(s, -1, s.long())
        if torch.equal(s2, s):
            return r
        s = s2
    return 16


def _matcher_k(name: str, args):
    """K of a matcher call's arguments (None for another kernel)."""
    if name == "matcher_block":
        return args[0].shape[-1]
    return args[3] if name == "matcher_block_packed" else None


def _wide_call(name: str, args) -> bool:
    """Whether a kernel call runs the wide matcher kernel: K above the
    largest with an instance of its own (matcher.FIXED_K)."""
    from tpu_snappy_torch.ops.kernels import matcher
    k = _matcher_k(name, args)
    return k is not None and k > matcher.FIXED_K


def _unpacked(name: str, args) -> torch.Tensor:
    """A matcher call's (B, N, K) candidate table."""
    if name == "matcher_block":
        return args[0]
    from tpu_snappy_torch.ops.kernels import matcher
    return matcher.unpack_table(args[0], args[1], args[3])


def _bound(name: str, args, outs) -> tuple:
    """Least time on the card for one call: the larger of the bytes the
    function must move (each distinct input tensor read once, each output
    written once; of gather_block's table, the entries its indices name;
    of ffill's payloads, the entries the fill reads: the set positions and
    those before a row's first) over the memory rate and its integer
    operations over the integer rate. Returns (ms, "bytes" or
    "operations")."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in _distinct(_tensors(args) + _tensors(outs)))
    if name == "ffill":
        mask, payloads = args[0], _distinct(list(args[1]))
        first = torch.where(mask.any(-1), mask.to(torch.int8).argmax(-1),
                            mask.shape[-1])
        used = int(mask.sum()) + int(first.sum())
        nbytes += (used - mask.numel()) * 4 * len(payloads)
    if name == "gather_block" and args[0].data_ptr() != args[1].data_ptr():
        # The table entries its indices name, not the whole table: the
        # chase reads 12288 of 65536 a row.
        x, idx = args[0], args[1]
        inside = (idx >= 0) & (idx < x.shape[1])
        rows = torch.arange(x.shape[0], device=idx.device)[:, None]
        used = torch.unique((rows * x.shape[1] + idx)[inside]).numel()
        nbytes += (used - x.numel()) * x.element_size()
    # Elements: positions, sources, or (gather_block) targets.
    first = _tensors(args)[1 if name == "gather_block" else 0]
    sticky = ("sig" if any(isinstance(a, str) and a == "sig" for a in args)
              else "exact")
    if _matcher_k(name, args) is not None:
        ops = matcher_ops(_unpacked(name, args), sticky)
    elif name == "resolve_block":  # 3 a position a round, then the gather
        ops = first.numel() * (3 * _doubling_rounds(args[1]) + 1)
    else:
        ops = first.numel() * _OPS[name]
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / INT_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _library_ms(name: str, args, dev) -> tuple:
    """(ms, graph_ms) of one PyTorch call computing the same function,
    where there is one: `torch.zeros` of a fresh output and `scatter_add_`
    into it for the three scatters, on the captured inputs (it counts no
    window drops and sums instead of joining limbs; the kernels too must
    hand back a fresh output), and `torch.gather` for gather_block,
    doubling_round (s o s; no stable tiles skipped, no flags) and the two
    windowed gathers (no window test), with its int64 index made
    beforehand, and `torch.cumsum` for cumsum_block. (None, None) for the
    others: no single PyTorch call computes the matcher's chain, the
    emission packs, the window keys, a forward fill, the element fields, a
    local round, a resolve or the next-set-position scan."""
    if name in ("gather_block", "doubling_round", "gather_window_block",
                "gather_window_anchored"):
        x, idx = args[0], args[0 if name == "doubling_round" else 1]
        ix = torch.clamp(idx, 0, x.shape[-1] - 1).to(torch.int64)
        return _both(lambda: torch.gather(x, -1, ix), dev)
    if name == "cumsum_block":
        x = args[0]
        return _both(lambda: torch.cumsum(x, -1, dtype=torch.int32), dev)
    if name not in ("scatter_windowed", "place_block", "scatter_block"):
        return None, None
    dest, values = args[0], args[1]
    if name == "place_block":
        cells = args[2] * 128  # out_rows
    elif name == "scatter_block":
        cells = args[3]  # out_cells
    else:
        cells = N
    keep = (dest >= 0) & (dest < cells)
    idx = torch.where(keep, dest, cells).to(torch.int64)
    shape = (dest.shape[0], cells + 1)
    return _both(lambda: torch.zeros(shape, dtype=torch.int32, device=dev)
                 .scatter_add_(1, idx, values), dev)


#: The scan kernel that computes each captured scan stage's function, on
#: the stage's own arguments.
SCAN_KERNEL = {"exclusive_cumsum": "cumsum_block",
               "next_element_start": "next_start_block"}


def _scan_agrees(name: str, args, out) -> bool:
    """The scan kernel's result against the stage the main path ran on the
    same arguments: the inclusive cumsum less x is exclusive_cumsum, and
    next_start_block is next_element_start at the main path's default
    (N, where the two functions agree)."""
    from tpu_snappy_torch.ops import scan
    if name == "cumsum_block":
        return torch.equal(out - args[0], scan.exclusive_cumsum(args[0]))
    return torch.equal(out, scan.next_element_start(*args))


def _with_scans(captured: dict, stages: dict) -> dict:
    """The captured kernel calls and, for each scan kernel, the captured
    arguments of the stage whose function it computes."""
    return {**captured, **{
        (SCAN_KERNEL[name], f"{name} in {stage}", shapes, scalars): call
        for (name, stage, shapes, scalars), call in stages.items()
        if name in SCAN_KERNEL}}


def _tiled_beside_block(dev, args, want, card: str) -> None:
    """resolve_tiled (no `resolved` flags), which computes resolve_block's
    function for src[p] <= p, on resolve_block's own captured call: its
    output must equal resolve_block's, and its graph_ms is the reading
    resolve_block's design is held to."""
    from tpu_snappy_torch.ops.kernels import tiledres
    got = tiledres.resolve_tiled(*args)
    if _exact(got, want):
        raise AssertionError("resolve_tiled differs from resolve_block on "
                             "resolve_block's captured call")
    ms, graph_ms = _both(lambda: tiledres.resolve_tiled(*args), dev)
    print(f"  beside it: resolve_tiled on the same call {ms} ms (graph_ms "
          f"{graph_ms}) [{card}]")


def check_main_path_calls(dev, captured: dict, stages: dict,
                          card: str) -> dict:
    """Phase 9: each kernel against its plain version, exact equality (ovf
    counts included), on the calls captured from the main path (the scan
    kernels on the captured scan stages' arguments, where each must also
    give the stage's own result); then the time of both on those tensors
    (CUDA events), the bound, and the library call's time. Returns, per
    kernel, the largest absolute difference over its captured calls and
    the numbers of its largest call (by the distinct bytes its arguments
    hold)."""
    kernels = _kernel_modules()
    captured = _with_scans(captured, stages)
    # resolve_tiled_dual is on no decode path: it runs on the first two
    # rows of the largest captured resolve_tiled call.
    args, kw = max(((a, k) for (name, *_), (a, k) in captured.items()
                    if name == "resolve_tiled"),
                   key=lambda c: c[0][0].shape[0])
    dual = tuple(a[:2].contiguous() for a in _tensors((args, kw)))
    captured = {**captured, ("resolve_tiled_dual", "resolve_tiled's first "
                             "two rows", tuple((tuple(a.shape), str(a.dtype))
                                               for a in dual), ()):
                (dual, {})}
    report = {}
    for (name, stage, shapes, scalars), (args, kw) in captured.items():
        mod = kernels[name]
        kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
        outs = kern(*args, **kw)
        got, want = _tensors(outs), _tensors(plain(*args, **kw))
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} results against "
                                 f"{len(want)}")
        err = max(_exact(g, w) for g, w in zip(got, want))
        if name in SCAN_KERNEL.values() and not _scan_agrees(name, args,
                                                             outs):
            raise AssertionError(f"{name} differs from {stage}'s result")
        ms, graph_ms = _both(lambda: kern(*args, **kw), dev)
        plain_ms = _timed(lambda: plain(*args, **kw), dev, 5)
        bound_ms, bound_by = _bound(name, (*args, *kw.values()), outs)
        library_ms, library_graph_ms = _library_ms(name, args, dev)
        size = sum(t.numel() * t.element_size()
                   for t in _distinct(_tensors((args, kw))))
        timed = isinstance(graph_ms, float) and graph_ms > 0
        share = bound_ms / graph_ms if timed else None
        ratio = (graph_ms / library_graph_ms
                 if timed and isinstance(library_graph_ms, float) else None)
        numbers = {"size": size, "ms": ms, "graph_ms": graph_ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms,
                   "library_graph_ms": library_graph_ms}
        entry = report.setdefault(name, {"size": -1, "err": 0, "shares": [],
                                         "ratios": [], "wide": None,
                                         "wide_shares": [],
                                         "wide_at_fixed_k": []})
        entry["err"] = max(entry["err"], err)
        if _matcher_k(name, args) is not None and not _wide_call(name, args):
            entry["wide_at_fixed_k"].append(_wide_beside(
                dev, name, args, kw, want, bound_ms, graph_ms, card))
        if _wide_call(name, args):
            # The wide matcher kernel: its own numbers, beside those of the
            # DEFAULT path's instances that the kernel line carries.
            entry["wide_shares"].append(share)
            if entry["wide"] is None or size > entry["wide"]["size"]:
                entry["wide"] = dict(numbers, k=_matcher_k(name, args),
                                     sticky=scalars[-1])
        else:
            entry["shares"].append(share)
            entry["ratios"].append(ratio)
            if size > entry["size"]:
                entry.update(numbers)
        print(f"main path {name} in {stage} {shapes} {scalars}: "
              f"max_abs_err={err}; kernel {ms} ms (graph_ms {graph_ms}), "
              f"plain {plain_ms} ms, bound {bound_ms} ms ({bound_by}), "
              f"library {library_ms} ms (graph_ms "
              f"{library_graph_ms}); bound / graph_ms {share}, graph_ms / "
              f"library graph_ms {ratio} [{card}]")
        if name == "resolve_block":
            _tiled_beside_block(dev, args, outs, card)
    missing = set(kernels) - set(report)
    if missing:
        raise AssertionError(f"no main-path call captured for {missing}")
    if any(r["err"] for r in report.values()):
        raise AssertionError(f"kernel disagrees with plain on the main "
                             f"path's tensors: {report}")

    _ffill_beyond_four(dev, captured, card)

    # resolve_tiled's worst case: the period-1 chain, 65535 hops deep.
    tiledres = kernels["resolve_tiled"]
    lit, chain, deps = _chain_case(dev, captured)
    batch = chain.shape[0]
    ms = _timed(lambda: tiledres.resolve_tiled(lit, chain), dev, 20)
    plain_ms = _timed(lambda: tiledres.resolve_tiled_plain(lit, chain), dev, 5)
    print(f"time resolve_tiled ({batch}, {N}) src=max(i-1,0), depth 65535: "
          f"kernel {ms} ms, plain {plain_ms} ms [{card}]")
    ms = _timed(lambda: tiledres.resolve_tiled_depth(
        lit, chain, deps, tiledres.DEPTH_TILE), dev, 20)
    print(f"time resolve_tiled_depth ({batch}, {N}) on the same chain, "
          f"depth 10 a tile: kernel {ms} ms [{card}]")
    resolve = kernels["resolve_block"]
    ms = _timed(lambda: resolve.resolve_block(lit, chain), dev, 20)
    print(f"time resolve_block ({batch}, {N}) on the same chain, at most "
          f"16 rounds: kernel {ms} ms [{card}]")
    return report


def _wide_beside(dev, name: str, args, kw: dict, want: list,
                 bound_ms: float, graph_ms, card: str) -> dict:
    """Phase 9, continued: the wide matcher kernel (matcher._wide) on a
    captured matcher call at an instance's K, equal to the plain version
    and timed beside the instance (graph_ms; the bound is the call's own),
    the evidence for routing every K to it. Returns its numbers."""
    import inspect
    from tpu_snappy_torch.ops.kernels import matcher
    wrapper = getattr(matcher, name)
    a = inspect.signature(wrapper).bind(*args, **kw)
    a.apply_defaults()
    a = a.arguments
    if name == "matcher_block_packed":
        table, k = (a["pref"], a["words"]), a["k"]
    else:
        table, k = (a["cands"],), a["cands"].shape[-1]
    call = (table, a["n"], k, a["lazy"], a["sticky"])
    err = max(_exact(g, w) for g, w in zip(matcher._wide(*call), want))
    if err:
        raise AssertionError(f"matcher._wide at K {k} differs from plain")
    ms, wide_ms = _both(lambda: matcher._wide(*call), dev)
    timed = isinstance(wide_ms, float) and wide_ms > 0
    share = bound_ms / wide_ms if timed else None
    print(f"wide at the instance's K: {name} K {k} {a['sticky']} lazy "
          f"{a['lazy']} {tuple(a['n'].shape)} rows: max_abs_err={err}; "
          f"wide kernel {ms} ms (graph_ms {wide_ms}), instance graph_ms "
          f"{graph_ms}, bound {bound_ms} ms; bound / graph_ms wide {share}, "
          f"instance {bound_ms / graph_ms if graph_ms else None} [{card}]")
    return {"k": k, "sticky": a["sticky"], "packed": len(table) == 2,
            "graph_ms": wide_ms, "bound_ms": bound_ms, "share": share,
            "instance_graph_ms": graph_ms}


def _ffill_beyond_four(dev, captured: dict, card: str) -> None:
    """Phase 9, continued: the fill past one launch's four payloads (no
    caller passes more today), on the largest captured ffill call's mask
    with 8 distinct payloads made from its own (x ^ i): equal to the plain
    version, timed with its bound beside the captured call itself (the
    one with the most payloads, then the most positions)."""
    from tpu_snappy_torch.ops.kernels import ffill
    args, kw = max(((a, k) for (name, *_), (a, k) in captured.items()
                    if name == "ffill"),
                   key=lambda c: (len(c[0][1]), c[0][0].numel()))
    mask, vals = args[0], tuple(args[1])
    wide = tuple(vals[i % len(vals)] ^ i for i in range(8))
    for payloads in (vals, wide):
        outs = ffill.ffill(mask, payloads, **kw)
        want = ffill.ffill_plain(mask, payloads, kw.get("max_gap"))
        err = max(_exact(g, w) for g, w in zip(outs, want))
        ms, graph_ms = _both(lambda: ffill.ffill(mask, payloads, **kw), dev)
        plain_ms = _timed(lambda: ffill.ffill_plain(
            mask, payloads, kw.get("max_gap")), dev, 5)
        bound_ms, bound_by = _bound("ffill", (mask, payloads), outs)
        print(f"ffill {tuple(mask.shape)} x {len(payloads)} payloads: "
              f"max_abs_err={err}; kernel {ms} ms (graph_ms {graph_ms}), "
              f"plain {plain_ms} ms, bound {bound_ms} ms ({bound_by}); "
              f"kernels a call: "
              f"{_kernel_split(lambda: ffill.ffill(mask, payloads, **kw))} "
              f"[{card}]")
        if err:
            raise AssertionError(f"ffill with {len(payloads)} payloads "
                                 f"differs from plain")


def _chain_case(dev, captured: dict) -> tuple:
    """The tiled resolves' worst case at the rows of the first captured
    resolve_tiled call: (lit, the period-1 chain src = max(p - 1, 0), 65535
    hops deep, and its exact depths, 10 in every 1024-tile)."""
    rng = np.random.default_rng(SEED + 1)
    batch = next(args[1].shape[0]
                 for (name, *_), (args, _) in captured.items()
                 if name == "resolve_tiled")
    chain = torch.from_numpy(np.tile(
        np.maximum(np.arange(N, dtype=np.int32) - 1, 0), (batch, 1))).to(dev)
    lit = torch.from_numpy(
        rng.integers(0, 256, (batch, N), dtype=np.int32)).to(dev)
    from tpu_snappy_torch.ops.kernels import tiledres
    deps = torch.full((batch, N // tiledres.DEPTH_TILE), 10,
                      dtype=torch.int32, device=dev)
    return lit, chain, deps


def _extreme(pick, values: list):
    """pick (min or max) over the measured values (None where a call has
    no library call or could not be captured in a graph); None if none
    was."""
    values = [v for v in values if v is not None]
    return pick(values) if values else None


#: The kernels whose earlier design `--parent` times beside this one.
#: scatter_windowed's kernels now also serve place_block (templated on
#: the limb count), so its own calls are timed against the parent's too;
#: ffill, resolve_tiled_flag and local_round took the TPU kernels'
#: max_gap and tiles, so their main-path calls are held to the parent's.
REDESIGNED = ("matcher_block_packed", "matcher_block", "emit_block_single",
              "emit_block", "resolve_tiled", "resolve_tiled_depth",
              "doubling_round", "place_block", "scatter_windowed",
              "resolve_block", "next_start_block", "ffill",
              "resolve_tiled_flag", "local_round")
#: The REDESIGNED kernels `--parent` also times on each captured call's
#: first SERVER_ROWS rows: the server's wave, where a serial walk's latency
#: does not shrink with the batch, and where a grid of few rows fills less
#: of the card.
FIRST_ROWS = ("resolve_tiled", "resolve_tiled_depth", "doubling_round",
              "place_block", "resolve_block", "resolve_tiled_flag")
SERVER_ROWS = 8


def _parent_kernels(parent: str) -> dict:
    """The wrappers of REDESIGNED in another checkout's port (for example
    the parent commit unpacked with `git archive`), its package loaded
    under the name `parent_port` (the kernel modules import the port's
    `format`), so that they build their own library from their own sources
    beside this checkout's."""
    import importlib
    import importlib.util
    import pathlib

    pkg = pathlib.Path(parent).resolve() / "tpu_snappy_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = module
    spec.loader.exec_module(module)
    kernels = _kernel_modules()
    return {name: _known_keywords(getattr(importlib.import_module(
        kernels[name].__name__.replace("tpu_snappy_torch", "parent_port")),
        name)) for name in REDESIGNED}


def _known_keywords(fn):
    """fn, dropping the keyword arguments it does not take: a parent
    wrapper that predates an argument (the tiled resolves' `tile` and
    `variant`) runs the value the main path passes (the decoder's tiles,
    "fori") without it."""
    import inspect
    names = set(inspect.signature(fn).parameters)

    @functools.wraps(fn)
    def call(*args, **kw):
        return fn(*args, **{k: v for k, v in kw.items() if k in names})
    return call


def _first_rows(args, kw: dict, n: int):
    """(args, kw) with every tensor cut to its first n rows."""
    def cut(a):
        return a[:n].contiguous() if isinstance(a, torch.Tensor) else a
    return tuple(map(cut, args)), {k: cut(v) for k, v in kw.items()}


def _in_turns(dev, old, new, args, kw, bound_ms: float,
              library_graph_ms) -> str:
    """The parent's and this checkout's wrapper on one call, in turns
    (parent, this, this, parent): ms, graph_ms and host_ms of each turn,
    and its bound share (bound / graph_ms) and library ratio (graph_ms /
    the library call's graph_ms, where there is one)."""
    turns = []
    for label, fn in (("parent", old), ("this", new), ("this", new),
                      ("parent", old)):
        ms, graph_ms = _both(lambda: fn(*args, **kw), dev)
        host_ms = _host_ms(lambda: fn(*args, **kw), dev)
        timed = isinstance(graph_ms, float) and graph_ms > 0
        share = bound_ms / graph_ms if timed else None
        ratio = (graph_ms / library_graph_ms
                 if timed and isinstance(library_graph_ms, float) else None)
        turns.append(f"{label} {ms} ms (graph_ms {graph_ms}, host_ms "
                     f"{host_ms}, bound share {share}, library ratio "
                     f"{ratio})")
    return "; ".join(turns)


def _kernel_split(fn, reps: int = 20) -> str:
    """Device microseconds a call of each kernel (and memset) a wrapper
    launches: torch.profiler's CUDA activity over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if e.device_time_total:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            parts.append(f"{name.replace('void ', '').strip()} "
                         f"{e.device_time_total / reps} us")
    return "; ".join(parts)


def compare_parent(dev, captured: dict, stages: dict, parent: str,
                   card: str) -> dict:
    """With `--parent DIR`: each REDESIGNED kernel of DIR's checkout and of
    this one on every captured main-path call (the scan kernels on the
    captured scan stages' arguments; the FIRST_ROWS kernels also on each
    call's first SERVER_ROWS rows; the matchers' wide calls against the
    parent's wide kernel), timed in turns (parent, this, this,
    parent), each turn giving ms (wrapper included), graph_ms (device
    only), host_ms (the wrapper's host cost), bound share and library
    ratio, then the device time of each kernel (and memset) each tree's
    wrapper launches (torch.profiler); the two outputs (every tensor of
    them: the drop counts and flags too) must be equal. Then phase 9's
    worst case for both trees: the tiled resolves and resolve_block on the
    period-1 chain (resolve_tiled_flag with its exact flags); and
    next_start_block at the other widths phase 3 runs (128 rows and one
    1-D row of seeded flags at M 384, 57344, 65536 and 69632). Returns the
    parent's wrappers."""
    old = _parent_kernels(parent)
    kernels = _kernel_modules()
    for (name, stage, shapes, scalars), (args, kw) in _with_scans(
            captured, stages).items():
        if name not in REDESIGNED:
            continue
        new = getattr(kernels[name], name)
        calls = [("", args, kw)]
        if name in FIRST_ROWS and args[0].shape[0] > SERVER_ROWS:
            calls.append((f", its first {SERVER_ROWS} rows",
                          *_first_rows(args, kw, SERVER_ROWS)))
        for part, a, k in calls:
            outs = new(*a, **k)
            was, now = _tensors(old[name](*a, **k)), _tensors(outs)
            if len(was) != len(now) or any(_exact(x, y)
                                           for x, y in zip(was, now)):
                raise AssertionError(f"{name}: the parent's output differs")
            cut = tuple((tuple(x.shape), str(x.dtype))
                        for x in _tensors((a, k)))
            bound_ms, _ = _bound(name, (*a, *k.values()), outs)
            turns = _in_turns(dev, old[name], new, a, k, bound_ms,
                              _library_ms(name, a, dev)[1])
            print(f"parent against this: {name} in {stage}{part} {cut} "
                  f"{scalars}: bound {bound_ms} ms; {turns} [{card}]")
            print(f"  kernels a call, parent: "
                  f"{_kernel_split(lambda: old[name](*a, **k))}; this: "
                  f"{_kernel_split(lambda: new(*a, **k))} [{card}]")
    lit, chain, deps = _chain_case(dev, captured)
    rng = np.random.default_rng(SEED + 2)
    hint = {"tile": kernels["resolve_tiled_depth"].DEPTH_TILE}
    roots = (torch.gather(chain, 1, chain.long()) == chain).to(torch.int32)
    extra = [("resolve_tiled", (lit, chain), {}, "the period-1 chain"),
             ("resolve_tiled_depth", (lit, chain, deps), hint,
              "the period-1 chain"),
             ("resolve_tiled_flag", (lit, chain, roots), {},
              "the period-1 chain"),
             ("resolve_block", (lit, chain), {}, "the period-1 chain")]
    for m in (384, 57344, 65536, 69632):
        flags = torch.from_numpy(rng.random((128, m)) < 0.1).to(dev)
        extra += [("next_start_block", (flags, m), {}, "seeded flags"),
                  ("next_start_block", (flags[0], m), {}, "a 1-D row")]
    for name, a, k, what in extra:
        new = getattr(kernels[name], name)
        outs = new(*a, **k)
        if _exact(old[name](*a, **k), outs):
            raise AssertionError(f"{name}: the parent's output differs")
        bound_ms, _ = _bound(name, a, outs)
        shape = tuple(a[0 if name == "next_start_block" else 1].shape)
        print(f"parent against this: {name} {shape} on {what}: "
              f"{_in_turns(dev, old[name], new, a, k, bound_ms, None)} "
              f"[{card}]")
    return old


def compare_parent_decode(dev, corpus: tuple, card: str) -> None:
    """With `--parent DIR`: phase 7's decode_corpus under "flagtail"
    (resolve_tiled_flag's main path) through the parent's port and this
    one, after one untimed call of each, in turns (parent, this, this,
    parent), host clock around each synchronised call; every output must
    equal the first."""
    import importlib
    from tpu_snappy_torch import api
    from tpu_snappy_torch.ops import decode

    trees = {"parent": importlib.import_module("parent_port.ops.decode"),
             "this": decode}

    def run(label):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out, _ = trees[label].decode_corpus(*corpus, resolve="flagtail",
                                            wave=api.API_WAVE)
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    first = run("parent")[0]
    run("this")
    turns = []
    for label in ("parent", "this", "this", "parent"):
        out, seconds = run(label)
        if not torch.equal(out, first):
            raise AssertionError("flagtail decode_corpus: the two trees' "
                                 "outputs differ")
        turns.append(f"{label} {seconds} s")
    print(f"parent against this: decode_corpus under flagtail: "
          f"{'; '.join(turns)} [{card}]")


def tile_sweep(dev, captured: dict, card: str) -> None:
    """With `--parent DIR`, the measurements behind the tile and chunk
    rules: scatter_block's captured calls at 1 to 66 tiles a row,
    scatter_windowed's at tiles of 512 to 16384 cells, place_block's (the
    windowed scatter at one limb) at tiles of 1024 to 16384 cells, and
    ffill's at every chunk size (each rule's choice among them), device
    only (graph_ms), each output equal to the wrapper's."""
    from tpu_snappy_torch.ops.kernels import ffill, place, scatter

    for (name, stage, shapes, scalars), (args, kw) in captured.items():
        if name not in ("scatter_block", "scatter_windowed", "place_block",
                        "ffill"):
            continue
        kern = getattr(_kernel_modules()[name], name)
        want = _tensors(kern(*args, **kw))
        if name == "scatter_block":
            dest, values, limbs, cells = args
            rule = scatter.block_tile(cells, dest.shape[1], limbs,
                                      dest.shape[0])
            units = cells // scatter.LO
            tiles = [-(-units // n) * scatter.LO
                     for n in (1, 2, 4, 8, 9, 16, 33, 66)]
            tiles = [c for c in tiles
                     if c * limbs * 4 <= scatter._build.SMEM_BYTES]
            key = "tile"
        elif name == "scatter_windowed":
            rule = scatter.windowed_tile(args[0].shape[0],
                                         kw.get("out_cells", N))
            tiles = [512, 1024, 2048, 4096, 8192, 16384]
            key = "tile"
        elif name == "place_block":
            dest, values, out_rows = args
            cells = out_rows * place.LO
            rule = scatter.windowed_tile(dest.shape[0], cells)
            tiles = [1024, 2048, 4096, 8192, 16384]
            key = "tile"
            kern = functools.partial(scatter.scatter_windowed, wrows=place.W,
                                     limbs=place.LIMBS, out_cells=cells)
            args, kw = (dest, values), {}
        else:
            rule = ffill.fill_chunk(*args[0].shape)
            tiles = list(ffill.CHUNKS)
            key = "chunk"
        res = []
        for size in tiles:
            fn = functools.partial(kern, *args, **kw, **{key: size})
            if any(_exact(a, b) for a, b in zip(_tensors(fn()), want)):
                raise AssertionError(f"{name} {key} {size} differs")
            res.append(f"{key} {size}{' (the rule)' if size == rule else ''}"
                       f" {_graph_ms(fn, dev)} ms")
        print(f"sweep {name} in {stage} {shapes} {scalars}, graph_ms: "
              f"{'; '.join(res)} [{card}]")


#: The tiled kernels resolve_tile_sweep times at every tile, and the tile
#: each runs at on the main path (the decoder's TAIL_TILE, HINT_TILE and
#: PARA_TILE).
SWEPT = {"resolve_tiled": 4096, "resolve_tiled_dual": 4096,
         "resolve_tiled_depth": 1024, "resolve_tiled_flag": 4096,
         "local_round": 4096}


def resolve_tile_sweep(dev, captured: dict, card: str, old: dict) -> None:
    """With `--parent DIR`, the tiled kernels at every tile they take
    (tiledres.TILES), device only (graph_ms), on each one's largest
    captured main-path call (resolve_tiled_dual on the first two rows of
    resolve_tiled's, with its `resolved` flags; resolve_tiled_depth with
    each tile's exact depths of the captured map, tile_depths_plain), each
    output equal to the plain version's at that tile; the main path's tile
    is marked. A kernel with a parent wrapper in `old` (the REDESIGNED
    ones) is timed in turns with it at every tile (parent, this, this,
    parent), the parent's output equal to this one's."""
    kernels = _kernel_modules()
    for name, main_tile in SWEPT.items():
        base = "resolve_tiled" if name == "resolve_tiled_dual" else name
        calls = [c for (n, *_), c in captured.items() if n == base]
        args, kw = max(calls, key=lambda c: c[0][0].numel())
        # The tensors alone: local_round's tile comes by position.
        args = tuple(a for a in args if isinstance(a, torch.Tensor))
        kw = dict(kw)
        if name == "resolve_tiled_dual":
            args = tuple(a[:2].contiguous() for a in args)
            kw = {k: v[:2].contiguous() if isinstance(v, torch.Tensor) else v
                  for k, v in kw.items() if k == "resolved"}
            args, kw = (*args, kw.pop("resolved", None)), {}
        mod = kernels[name]
        kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
        res = []
        for tile in mod.TILES:
            a, k = args, {**kw, "tile": tile}
            if name == "resolve_tiled_depth":
                a = (*args[:2], mod.tile_depths_plain(args[1], tile))
            fn = functools.partial(kern, *a, **k)
            if _exact(fn(), plain(*a, **k)):
                raise AssertionError(f"{name} at tile {tile} differs")
            mark = " (main path)" if tile == main_tile else ""
            if name not in old:
                res.append(f"tile {tile}{mark} {_graph_ms(fn, dev)} ms")
                continue
            was = functools.partial(old[name], *a, **k)
            if _exact(was(), fn()):
                raise AssertionError(f"{name} at tile {tile}: the parent's "
                                     "output differs")
            turns = [_graph_ms(f, dev) for f in (was, fn, fn, was)]
            res.append(f"tile {tile}{mark} {turns[1]} / {turns[2]} ms "
                       f"(parent {turns[0]} / {turns[3]})")
        shapes = tuple(tuple(t.shape) for t in _tensors(args))
        print(f"tile sweep {name} {shapes}, graph_ms: {'; '.join(res)} "
              f"[{card}]")


#: Blocks of phase 8's traced compresses above K 16 (_wide_k), each
#: stream equal to the CPU's and decoded by reference_codec.
WIDE_BLOCKS = 8


def _wide_k(ks=((17, "exact", "class"), (18, "sig", "class"),
                (32, "exact", "class"), (32, "sig", "class"),
                (64, "exact", "class"), (64, "sig", "class"))):
    """The matchers above K 16 on the main path (phase 8's traced
    compresses, which phase 9 holds against plain): DEFAULT_CONFIG at each
    (K, sticky, flatten) of `ks`; by default K 17 "exact" and 18 "sig"
    (kernel instances of their own) and K 32 and 64 at "exact" and "sig"
    (the wide kernel)."""
    from tpu_snappy_torch import config
    return tuple(dataclasses.replace(config.DEFAULT_CONFIG, candidates=k,
                                     probes=k, sticky=sticky,
                                     flatten=flatten)
                 for k, sticky, flatten in ks)


#: The wide kernel's configs phase 8 also compresses at the API's wave
#: (128 blocks), for phase 9's times at the main path's rows: the packed
#: form at K 32 and 64, both sticky modes, and the unpacked one (flatten
#: "off") at K 32.
WIDE_WAVE = ((32, "exact", "class"), (32, "sig", "class"),
             (64, "exact", "class"), (64, "sig", "class"),
             (32, "exact", "off"))


def _flat_off():
    """DEFAULT_CONFIG without flattening: the unpacked matcher route."""
    from tpu_snappy_torch import config
    return dataclasses.replace(config.DEFAULT_CONFIG, flatten="off")


def _launches(wrappers: dict) -> dict:
    return {k: w.launches for k, w in wrappers.items()}


def _reset(wrappers: dict) -> None:
    for w in wrappers.values():
        w.launches = 0


def preset_round_trips(dev, data: bytes, wrappers: dict, card: str):
    """Phase 6: the 16 MiB through api.compress / api.decompress under
    FAST, TURBO, ULTRA and flatten "off", each run with the launch counters
    set to 0 just before and read just after; the host goldens decode each
    stream and its first 4 blocks equal the port's CPU stream. Then a
    framed sidecar "auto" round trip under ULTRA. Returns the launches of
    all these runs."""
    from tpu_snappy_torch import api, config, framing
    from tpu_snappy_torch.ops import decode as ops_decode

    total = dict.fromkeys(wrappers, 0)
    runs = {"FAST": config.FAST_CONFIG, "TURBO": config.TURBO_CONFIG,
            "ULTRA": config.ULTRA_CONFIG, 'flatten "off"': _flat_off()}
    for name, cfg in runs.items():
        _reset(wrappers)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        comp = api.compress(data, cfg, device="cuda")
        t1 = time.perf_counter()
        back, stats = api.decompress_with_stats(comp, cfg, device="cuda")
        t2 = time.perf_counter()
        launches = _launches(wrappers)
        peak = torch.cuda.max_memory_allocated(dev)
        if back != data:
            raise AssertionError(f"{name} round trip changed the data")
        if stats.path != "device" or stats.spliced:
            raise AssertionError(f"{name} decode left the device: {stats}")
        matcher = ("matcher_block" if cfg.flatten == "off"
                   else "matcher_block_packed")
        need = [matcher, "ffill", "emit_block_single", "place_block",
                "scatter_block", "scatter_windowed", "resolve_tiled"]
        if cfg.stride == 1:
            need.append("window_keys")
        if sum(stats.dense_rounds):
            need.append("gather_block")
        missing = [k for k in need if not launches[k]]
        if missing:
            raise AssertionError(f"{name}: kernels that did not run: "
                                 f"{missing}; {launches}")
        print(f"preset {name} (K={cfg.candidates}, sticky {cfg.sticky}, "
              f"stride {cfg.stride}, flatten {cfg.flatten}): {len(data)} -> "
              f"{len(comp)} bytes (ratio {len(comp) / len(data)}); compress "
              f"{t1 - t0} s, {len(data) / (t1 - t0) / 1e9} GB/s; decompress "
              f"{t2 - t1} s, {len(data) / (t2 - t1) / 1e9} GB/s; peak device "
              f"memory {peak} bytes; dense rounds per wave "
              f"{stats.dense_rounds} [{card}]")
        print(f"  launches: {launches}")
        for k, v in launches.items():
            total[k] += v
        check_goldens(data, comp, cfg, foreign=False)

    golden = ops_decode.native_golden()
    _reset(wrappers)
    t0 = time.perf_counter()
    fr = framing.compress(data, config.ULTRA_CONFIG, None, "auto",
                          device="cuda")
    t1 = time.perf_counter()
    back, st = framing.decompress_with_stats(fr, device="cuda")
    t2 = time.perf_counter()
    launches = _launches(wrappers)
    if back != data or golden.uncompress_framed(
            fr, max_out=len(data) + 16) != data:
        raise AssertionError("framed ULTRA auto stream differs")
    if st.redecoded_hinted or not (st.hinted or st.root_map):
        raise AssertionError(f"framed ULTRA auto: {st}")
    if st.hinted and not launches["resolve_tiled_depth"]:
        raise AssertionError(f"framed ULTRA: no hinted resolve {launches}")
    if launches["crc32c_rows"] != 1:
        raise AssertionError(f"framed ULTRA: crc32c_rows launched "
                             f"{launches['crc32c_rows']} times, not once")
    print(f"framed ULTRA auto: {len(fr)} bytes; compress {t1 - t0} s, "
          f"decompress {t2 - t1} s; {st} [{card}]")
    for k, v in launches.items():
        total[k] += v
    return total


def placement_wave(dev, data: bytes, wrappers: dict, card: str) -> dict:
    """Phase 6, continued: one wave of the 16 MiB through encode_blocks at
    every placement, with the launch counters set to 0 just before and
    read just after; each gives the bytes of "auto". Then a second,
    timed pass. Returns the launches of the first."""
    from tpu_snappy_torch import api
    from tpu_snappy_torch.ops import encode

    blocks, lengths = api._to_blocks(data)
    bt = torch.from_numpy(blocks[:api.API_WAVE]).to(dev)
    lt = torch.from_numpy(lengths[:api.API_WAVE]).to(dev)
    _reset(wrappers)
    outs = {p: encode.encode_blocks(bt, lt, placement=p)
            for p in encode.PLACEMENTS}
    launches = _launches(wrappers)
    print(f"placement launches: {launches}")
    for p in encode.PLACEMENTS:  # timed after the first (warm-up) pass
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        encode.encode_blocks(bt, lt, placement=p)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"placement {p}: encode_blocks {ms} ms for {bt.shape[0]} "
              f"blocks [{card}]")
    out, lens = outs["auto"]
    for p, (o, n) in outs.items():
        if not (torch.equal(n, lens) and torch.equal(o, out)):
            raise AssertionError(f"placement {p} differs from auto")
    need = ["emit_block", "emit_block_single", "place_block", "scatter_block"]
    if any(not launches[k] for k in need):
        raise AssertionError(f"placement kernels did not run: {launches}")
    print(f"placements {', '.join(encode.PLACEMENTS)}: identical bytes "
          f"({int(lens.sum())} over {len(lens)} blocks)")
    return launches


def _corpus(dev, comp: bytes, wave: int) -> tuple:
    """The fragments of a raw stream as decode_corpus takes them: (frags,
    clens, ulens) on the card at the stream's width, padded with empty
    fragments to a multiple of `wave`."""
    from tpu_snappy_torch import format as fmt
    from tpu_snappy_torch.ops import decode

    total, start = fmt.varint_decode(comp)
    frags, clens, ulens = decode.fragment_table(comp, start, total)
    pad = -len(ulens) % wave
    frags = np.pad(frags[:, :decode.frag_width(clens)], ((0, pad), (0, 0)))
    clens, ulens = (np.pad(a, (0, pad)) for a in (clens, ulens))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (frags, clens, ulens))


def resolve_modes(dev, data: bytes, comp: bytes, wrappers: dict, card: str):
    """Phase 7: the DEFAULT stream through decode_corpus at the API's wave
    under every resolve mode ("hybrid" with WINDOWED_OPENING off and on),
    "tiledtail" with fields="kernel", and "kernel" and "stable" without
    the run collapse, each run with the launch counters set to 0 just
    before and read just after. Each must give the input bytes, every
    fragment ok, and "tiledtail"'s output exactly, and launch its run's
    kernel. Returns (the launches of all these runs, the fragments on the
    card)."""
    from tpu_snappy_torch import api
    from tpu_snappy_torch.ops import decode

    corpus = _corpus(dev, comp, api.API_WAVE)
    ulens = corpus[2].cpu().numpy()
    total = dict.fromkeys(wrappers, 0)
    rounds, steps = [], []
    decode_fragments, sparse_chase = decode.decode_fragments, \
        decode.sparse_chase

    def counted(*args, **kwargs):  # decode_corpus's waves, with rounds
        res = decode_fragments(*args, **kwargs)
        rounds.append(res[2])
        return res

    def chased(*args):  # "hybrid"'s chase steps, the most of a wave
        res = sparse_chase(*args)
        steps.append(int(res[2].max()))
        return res

    runs = [(m, "auto", True, False)
            for m in ("tiledtail", "tiled", "flagtail", "paratail", "kernel",
                      "stable", "plain", "windowed", "hybrid")]
    runs += [("hybrid", "auto", True, True), ("auto", "auto", True, False),
             ("tiledtail", "kernel", True, False),
             ("kernel", "auto", False, False),
             ("stable", "auto", False, False)]
    first = None
    decode.decode_fragments, decode.sparse_chase = counted, chased
    try:
        for mode, fields, collapse, opening in runs:
            rounds.clear()
            steps.clear()
            decode.WINDOWED_OPENING = opening
            _reset(wrappers)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out, ok = decode.decode_corpus(*corpus, resolve=mode,
                                           fields=fields,
                                           collapse_runs=collapse,
                                           wave=api.API_WAVE)
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            launches = _launches(wrappers)
            label = (f"resolve {mode} fields {fields} (collapse_runs="
                     f"{collapse}, WINDOWED_OPENING={opening})")
            host = out.cpu().numpy()
            back = b"".join(host[i, :n].tobytes() for i, n in enumerate(ulens))
            if back != data or not bool(ok.all()):
                raise AssertionError(f"decode_corpus {label} differs from "
                                     f"the input")
            first = out if first is None else first
            if not torch.equal(out, first):
                raise AssertionError(f"{label} differs from tiledtail")
            need = MODE_KERNEL.get((mode, fields, opening))
            if need and not launches[need]:
                raise AssertionError(f"{label}: {need} did not run; "
                                     f"{launches}")
            chase = f", chase steps per wave {steps}" if steps else ""
            print(f"{label}: decode_corpus {seconds} s, "
                  f"{len(data) / seconds / 1e9} GB/s, rounds per wave "
                  f"{rounds}{chase}; load average {os.getloadavg()} "
                  f"[{card}]")
            print(f"  launches: {launches}")
            for k, v in launches.items():
                total[k] += v
    finally:
        decode.WINDOWED_OPENING = False
        decode.decode_fragments, decode.sparse_chase = decode_fragments, \
            sparse_chase
    return total, corpus


def compress_memory(dev, data: bytes, card: str) -> None:
    """Phase 8, first part: compress keeps the whole corpus on the device
    (the input, its encoded rows, the compacted stream), so its peak
    device memory grows with the input beyond the wave's working set.
    Measures the peak above what was allocated before at len(data) and at
    64 times that (1 GiB), and prints the growth per input byte."""
    from tpu_snappy_torch import api
    from tpu_snappy_torch.ops import decode as ops_decode

    golden = ops_decode.native_golden()
    peaks = {}
    for k in (1, 64):
        d = data * k
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        comp = api.compress(d, device="cuda")
        torch.cuda.synchronize(dev)
        peaks[len(d)] = torch.cuda.max_memory_allocated(dev) - base
        if golden is not None and golden.uncompress(comp) != d:
            raise AssertionError(f"the {len(d)}-byte stream does not decode")
    (n1, p1), (n4, p4) = sorted(peaks.items())
    print(f"compress peak device memory above the baseline: {p1} bytes at "
          f"{n1} input bytes, {p4} bytes at {n4}; {(p4 - p1) / (n4 - n1)} "
          f"bytes per further input byte (wave {api.API_WAVE}) [{card}]")


def round_trip(dev, wrappers: dict):
    """Phase 4: 16 MiB through the port's API on the card, with the launch
    counters read around exactly that run."""
    from tpu_snappy_torch import api

    data = make_data(ROUND_TRIP_BYTES)
    print(f"round trip input: {len(data)} bytes, "
          f"{-(-len(data) // N)} blocks (last partial)")
    _reset(wrappers)
    torch.cuda.reset_peak_memory_stats(dev)
    comp = api.compress(data, device="cuda")
    back, stats = api.decompress_with_stats(comp, device="cuda")
    launches = _launches(wrappers)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"raw path launches: {launches}")
    if back != data:
        raise AssertionError("round trip on the card changed the data")
    if stats.path != "device" or stats.spliced:
        raise AssertionError(f"decode left the device: {stats}")
    missing = [k for k, n in launches.items()
               if not n and k not in NOT_RAW]
    if missing:
        raise AssertionError(f"kernels the raw path did not run: {missing}")
    waves = len(stats.dense_rounds)
    if min(stats.dense_rounds) < 1 or launches["gather_block"] < waves:
        raise AssertionError(f"dense rounds {stats.dense_rounds}")
    print(f"round trip ok: {len(data)} -> {len(comp)} bytes (ratio "
          f"{len(comp) / len(data)}), {stats.fragments} fragments, "
          f"{stats.spliced} spliced on the host, dense rounds per wave "
          f"{stats.dense_rounds}")
    return data, comp, launches, peak


def framed_round_trips(data: bytes, wrappers: dict, card: str):
    """Phase 5: the 16 MiB through the framed container under each sidecar
    policy, with the launch counters set to 0 just before and read just
    after. Returns (streams by policy, launches, FramedStats of each
    policy's decode with its sidecars)."""
    from tpu_snappy_torch import framing
    from tpu_snappy_torch.ops import decode as ops_decode

    golden = ops_decode.native_golden()
    if golden is None:
        raise AssertionError("the C++ golden (hints, framed decoder) does "
                             "not build here")
    streams, stats = {}, {}
    _reset(wrappers)
    for policy in ("off", "auto", "always"):
        t0 = time.perf_counter()
        fr = framing.compress(data, sidecar=policy, device="cuda")
        t1 = time.perf_counter()
        streams[policy] = fr
        if golden.uncompress_framed(fr, max_out=len(data) + 16) != data:
            raise AssertionError(f"golden mis-decodes the {policy} stream")
        kinds = {name: sum(1 for typ in _chunk_types(fr) if typ == code)
                 for name, code in (("0x00", 0), ("0x01", 1),
                                    ("0x80", 0x80), ("0x81", 0x81))}
        print(f"framed {policy}: {len(fr)} bytes, chunks {kinds}; compress "
              f"{t1 - t0} s, {len(data) / (t1 - t0) / 1e9} GB/s [{card}]")
        for use in (True, False):
            gathers = wrappers["gather_block"].launches
            t0 = time.perf_counter()
            back, st = framing.decompress_with_stats(fr, use_sidecar=use,
                                                     device="cuda")
            t1 = time.perf_counter()
            if back != data:
                raise AssertionError(f"framed {policy} decode differs")
            stats[policy, use] = (st, wrappers["gather_block"].launches
                                  - gathers)
            print(f"  decompress use_sidecar={use}: {t1 - t0} s, "
                  f"{len(data) / (t1 - t0) / 1e9} GB/s; {st} [{card}]")
    launches = _launches(wrappers)
    print(f"framed path launches: {launches}")
    if launches["crc32c_rows"] != len(streams):
        raise AssertionError(f"crc32c_rows launched {launches['crc32c_rows']}"
                             f" times for {len(streams)} framed compresses "
                             "on one shard")
    auto, always = stats["auto", True][0], stats["always", True]
    if not auto.hinted or not always[0].root_map:
        raise AssertionError("no hinted chunk under auto or no root-map "
                             "chunk under always")
    if any(st.redecoded_hinted for st, _ in stats.values()):
        raise AssertionError("a hinted chunk was re-decoded after a CRC "
                             "miss")
    # The always decode's gathers beyond its dense rounds are the sidecar's
    # 1-limb byte gathers, one a root-map wave.
    sidecar_gathers = always[1] - sum(always[0].dense_rounds)
    if not launches["resolve_tiled_depth"] or sidecar_gathers < 1:
        raise AssertionError(f"framed kernels did not run: {launches}, "
                             f"sidecar gathers {sidecar_gathers}")
    return streams, launches, {p: stats[p, True][0] for p in streams}


def _chunk_types(fr: bytes):
    ip = 10  # past the stream identifier
    while ip < len(fr):
        yield fr[ip]
        ip += 4 + int.from_bytes(fr[ip + 1: ip + 4], "little")


def check_goldens(data: bytes, comp: bytes, cfg=None,
                  foreign: bool = True) -> None:
    """Phase 4, continued: the host codecs decode the port's stream (made
    at `cfg`, default DEFAULT_CONFIG), the card decodes theirs (where
    `foreign`), and the CUDA stream equals the CPU stream on 4 blocks."""
    from tpu_snappy_torch import api, config, reference_codec
    from tpu_snappy_torch.native import realsnappy
    from tpu_snappy_torch.ops import decode as ops_decode

    goldens = ["reference_codec"]
    if reference_codec.decompress(comp) != data:
        raise AssertionError("reference_codec decodes the port's stream "
                             "differently")
    golden = ops_decode.native_golden()
    if golden is not None:
        goldens.append("native golden (C++)")
        if golden.uncompress(comp) != data:
            raise AssertionError("native golden disagrees")
    if realsnappy.available():
        goldens.append("system libsnappy")
        if realsnappy.uncompress(comp) != data:
            raise AssertionError("libsnappy disagrees")
    print(f"goldens that decoded the port's stream: {', '.join(goldens)}"
          f" (system libsnappy loads: {realsnappy.available()})")

    others = {}
    if foreign:
        others["reference_codec (first 2 MiB)"] = (
            data[:2 << 20], reference_codec.compress(data[:2 << 20]))
        if golden is not None:
            others["native golden"] = (data, golden.compress(data))
        if realsnappy.available():
            others["system libsnappy"] = (data, realsnappy.compress(data))
    for label, (plain, stream) in others.items():
        got, st = api.decompress_with_stats(stream, device="cuda")
        if got != plain:
            raise AssertionError(f"the card mis-decodes a {label} stream")
        print(f"decoded on the card: {label} stream of {len(stream)} bytes "
              f"({st.fragments} fragments, {st.spliced} spliced)")

    cfg = cfg or config.DEFAULT_CONFIG
    head = data[:4 * N]
    cpu_stream = api.compress(head, cfg, device="cpu", small_fastpath=False)
    gpu_stream = api.compress(head, cfg, device="cuda", small_fastpath=False)
    if cpu_stream != gpu_stream:
        raise AssertionError("CUDA and CPU streams differ on 4 blocks")
    print(f"first 4 blocks: CUDA stream == CPU stream ({len(gpu_stream)} "
          f"bytes)")


#: The kernels of the raw and framed main paths (PERF.md §6 rows 1-10):
#: phase 10 must launch each of them under the sharded paths, phase 11
#: through the server.
SHARDED_PATH_KERNELS = ("window_keys", "ffill", "scatter_windowed",
                        "resolve_tiled", "matcher_block_packed",
                        "emit_block_single", "place_block", "scatter_block",
                        "gather_block", "resolve_tiled_depth", "crc32c_rows")


def _rate(nbytes: int, seconds: float) -> str:
    return f"{seconds} s, {nbytes / seconds / 1e9} GB/s"


def parallel_and_surfaces(dev, data: bytes, comp: bytes, framed: dict,
                          framed_stats: dict, wrappers: dict, card: str):
    """Phase 10: the 16 MiB through the sharded paths on a one-card mesh
    and on four shards of cuda:0 (shard.encode_dp / decode_dp, also of
    the C++ golden's stream), streaming.compress_stream in 4 waves, the
    framed container with a mesh under each policy (compress, decompress,
    decompress_stream), each stream equal to phase 4's or 5's and each
    framed decode taking the same chunks down the same paths as phase 5's,
    with the launch counters set to 0 just before and read just after;
    then two processes on cuda:0 over gloo (multihost), the compat and
    hadoop round trips, and the CLI in subprocesses, each output equal to
    the API's bytes. The sharded paths' launches print on their own line."""
    import io
    import tempfile

    import torch_multiproc
    from tpu_snappy_torch import __main__ as _cli  # noqa: F401 (import check)
    from tpu_snappy_torch import api, compat, framing, hadoop
    from tpu_snappy_torch.config import DEFAULT_CONFIG, TURBO_CONFIG
    from tpu_snappy_torch.ops import decode as ops_decode
    from tpu_snappy_torch.parallel import mesh as meshlib, shard, streaming

    golden = ops_decode.native_golden()
    meshes = {"one-card mesh": meshlib.make_mesh(1),
              "four shards on cuda:0": meshlib.make_mesh(device=(dev,) * 4)}
    n = len(data)
    _reset(wrappers)
    for label, mesh in meshes.items():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = shard.encode_dp(data, mesh)
        t1 = time.perf_counter()
        back = shard.decode_dp(got, mesh, DEFAULT_CONFIG)
        t2 = time.perf_counter()
        if got != comp or back != data:
            raise AssertionError(f"encode_dp / decode_dp on the {label} "
                                 "differ from the API")
        if shard.decode_dp(golden.compress(data), mesh) != data:
            raise AssertionError(f"decode_dp on the {label} mis-decodes "
                                 "the golden's stream")
        print(f"encode_dp, {label}: {_rate(n, t1 - t0)}; decode_dp: "
              f"{_rate(n, t2 - t1)} [{card}]")
    one = meshes["one-card mesh"]
    dst = io.BytesIO()
    t0 = time.perf_counter()
    st = streaming.compress_stream(io.BytesIO(data), dst, n, one,
                                   blocks_per_wave=64)
    t1 = time.perf_counter()
    if dst.getvalue() != comp or st.waves != 4 or st.in_bytes != n \
            or st.out_bytes != len(comp):
        raise AssertionError(f"streamed encode differs: {st}")
    print(f"streaming.compress_stream, one-card mesh, 64 blocks a wave: "
          f"{_rate(n, t1 - t0)}; {st} [{card}]")
    for policy, want in framed.items():
        t0 = time.perf_counter()
        fr = framing.compress(data, DEFAULT_CONFIG, one, policy)
        t1 = time.perf_counter()
        back, st = framing.decompress_with_stats(fr, DEFAULT_CONFIG, one)
        t2 = time.perf_counter()
        out = io.BytesIO()
        framing.decompress_stream(io.BytesIO(fr), out, one)
        if fr != want or back != data or out.getvalue() != data:
            raise AssertionError(f"framed {policy} with a mesh differs")
        ref = framed_stats[policy]
        for k in ("root_map", "hinted", "normal", "host", "uncompressed",
                  "redecoded_root_map", "redecoded_hinted"):
            if getattr(st, k) != getattr(ref, k):
                raise AssertionError(f"framed {policy} with a mesh: {k} "
                                     f"{getattr(st, k)} against "
                                     f"{getattr(ref, k)}")
        print(f"framed {policy}, one-card mesh: compress {_rate(n, t1 - t0)};"
              f" decompress {_rate(n, t2 - t1)}; {st} [{card}]")
    launches = _launches(wrappers)
    print(f"sharded path launches: {launches}")
    missing = [k for k in SHARDED_PATH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"kernels the sharded paths did not run: "
                             f"{missing}")

    t0 = time.perf_counter()
    res = torch_multiproc.run(data, nprocs=2, shards=(str(dev),),
                              blocks_per_wave=128, timeout=300, threads=2)
    t1 = time.perf_counter()
    if res["oneshot"] != comp or res["stream"] != comp:
        raise AssertionError("two processes over gloo: rank 0's stream "
                             "differs from the API's")
    print(f"two processes on {dev} over gloo: compress_dp_global and "
          f"compress_multihost equal the API stream; global shards "
          f"{res['global_shards']}, {res['waves']} waves; {t1 - t0} s "
          "with both processes' start")

    if compat.compress(data) != comp or compat.uncompress(comp) != data:
        raise AssertionError("compat raw round trip differs")
    sc = compat.StreamCompressor().add_chunk(data)
    if sc != framed["off"] or \
            compat.StreamDecompressor().decompress(sc) != data:
        raise AssertionError("compat stream round trip differs")
    blob = hadoop.compress(data)
    if hadoop.decompress(blob) != data:
        raise AssertionError("hadoop round trip differs")
    print(f"compat and hadoop round trips ok (hadoop {len(blob)} bytes)")

    wants = {"raw": ([], comp),
             "framed auto": (["--framed", "--sidecar", "auto"],
                             framed["auto"]),
             "hadoop": (["--hadoop"], blob), "mesh 1": (["--mesh", "1"], comp),
             "stream": (["--stream"], comp),
             "turbo": (["--turbo"], api.compress(data, TURBO_CONFIG))}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.bin")
        with open(src, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", "tpu_snappy_torch", "compress", src,
             os.path.join(tmp, k.replace(" ", "_"))] + flags,
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for k, (flags, _w) in wants.items()}
        try:
            logs = {k: p.communicate(timeout=300)[0].decode(errors="replace")
                    for k, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        t1 = time.perf_counter()
        for k, (_f, want) in wants.items():
            with open(os.path.join(tmp, k.replace(" ", "_")), "rb") as f:
                got = f.read() if procs[k].returncode == 0 else None
            if got != want:
                raise AssertionError(f"CLI {k}: exit {procs[k].returncode}"
                                     f", output differs:\n{logs[k][-2000:]}")
            print(f"CLI {k}: {logs[k].strip()}")
    print(f"CLI: {len(wants)} processes at once, {t1 - t0} s, each output "
          "equal to the API's bytes")


#: Phase 11's requests: the 16 MiB in slices of four blocks (the last
#: takes the remainder), each compressed raw and framed under every
#: policy, and SERVER_SMALL slices below one block (the host fast path),
#: compressed raw; then every stream decompressed. SERVER_THREADS threads
#: submit at once.
SERVER_SLICE = 4 * N
SERVER_SMALL = ((0, 1000), (5000, 40000), (100000, 165535), (300000, 300001))
SERVER_THREADS = 8
POLICIES = ("off", "auto", "always")


def _server_configs(dev) -> dict:
    """Phase 11's servers, each made when its turn comes: waves of 8 and
    of the API's 128 at PIPELINE_DEPTH 1 and 2 (set on a subclass before
    construction; at 128 in turns, twice each), and a mesh of four shards
    of the card at the default depth."""
    from tpu_snappy_torch import api, serving
    from tpu_snappy_torch.parallel import mesh as meshlib

    def at_depth(depth: int):
        return type(f"Depth{depth}", (serving.CodecServer,),
                    {"PIPELINE_DEPTH": depth})

    def server(wave: int, depth: int, **kw):
        return lambda: at_depth(depth)(wave=wave, **kw)

    big = api.API_WAVE
    return {
        "wave 8, depth 1": server(8, 1),
        "wave 8, depth 2": server(8, 2),
        f"wave {big}, depth 1": server(big, 1),
        f"wave {big}, depth 2": server(big, 2),
        f"wave {big}, depth 2, again": server(big, 2),
        f"wave {big}, depth 1, again": server(big, 1),
        "wave 8, depth 2, four shards on cuda:0":
            server(8, 2, mesh=meshlib.make_mesh(device=(dev,) * 4)),
    }


def _split_framed(fr: bytes, blocks: int) -> list:
    """A framed stream cut into streams of `blocks` data chunks each (with
    their sidecar chunks): what framing.compress gives for each slice of
    `blocks` blocks, since a chunk depends on its own block alone."""
    from tpu_snappy_torch import framing

    out, count = [], 0
    ip = start = len(framing.STREAM_ID)
    while ip < len(fr):
        typ = fr[ip]
        ip += 4 + int.from_bytes(fr[ip + 1:ip + 4], "little")
        if typ in (framing.CHUNK_COMPRESSED, framing.CHUNK_UNCOMPRESSED):
            count += 1
            if count == blocks or ip == len(fr):
                out.append(framing.STREAM_ID + fr[start:ip])
                start, count = ip, 0
    return out


def _serve_mix(srv, requests: list, jobs: list) -> tuple:
    """Phase 11's mix through one server: SERVER_THREADS threads each
    compress their share of `jobs` ((request index, "raw" or a policy),
    all submitted before any result is read), then decompress every
    stream; the first thread also sends CORRUPT_STREAM among its
    decompresses. Returns (streams, decodes, the corrupt request's
    exception, compress seconds, decompress seconds). Any other future
    that fails raises here."""
    import concurrent.futures as cf

    def compress(share):
        futs = {(i, k): srv.compress(requests[i]) if k == "raw"
                else srv.compress_framed(requests[i], k) for i, k in share}
        return {key: f.result(timeout=600) for key, f in futs.items()}

    def decompress(job):
        t, streams = job
        bad = srv.decompress(CORRUPT_STREAM) if t == 0 else None
        futs = {key: srv.decompress(c) if key[1] == "raw"
                else srv.decompress_framed(c) for key, c in streams.items()}
        outs = {key: f.result(timeout=600) for key, f in futs.items()}
        return outs, bad.exception(timeout=600) if bad else None

    shares = [jobs[t::SERVER_THREADS] for t in range(SERVER_THREADS)]
    with cf.ThreadPoolExecutor(SERVER_THREADS) as pool:
        t0 = time.perf_counter()
        parts = list(pool.map(compress, shares))
        t1 = time.perf_counter()
        done = list(pool.map(decompress, enumerate(parts)))
        t2 = time.perf_counter()
    streams = {k: v for part in parts for k, v in part.items()}
    backs = {k: v for outs, _e in done for k, v in outs.items()}
    return streams, backs, done[0][1], t1 - t0, t2 - t1


def serving_phase(dev, data: bytes, framed: dict, wrappers: dict,
                  card: str) -> None:
    """Phase 11: the 16 MiB through serving.CodecServer on the card in
    every configuration of _server_configs, each stream equal to
    api.compress of its request on the card or to framing.compress under
    its policy (phase 5's stream of the whole input, cut at the requests'
    chunks; the cut held against framing.compress on the first and the
    last slice), each decode equal to its request, the corrupt stream's
    future failing with ValueError and no other, every wave kind
    dispatched, and the launch counters (set to 0 after the reference
    streams, read after the last server) showing the eleven kernels of the
    raw and framed paths."""
    from tpu_snappy_torch import api, framing

    t0 = time.perf_counter()
    requests = [data[s:s + SERVER_SLICE]
                for s in range(0, len(data), SERVER_SLICE)]
    big = len(requests)
    want = {(i, "raw"): api.compress(r) for i, r in enumerate(requests)}
    for policy in POLICIES:
        cut = _split_framed(framed[policy], SERVER_SLICE // N)
        for i in (0, big - 1):
            if cut[i] != framing.compress(requests[i], sidecar=policy):
                raise AssertionError(f"framed {policy}: slice {i} of the "
                                     "whole stream differs")
        want.update({(i, policy): fr for i, fr in enumerate(cut)})
    for a, b in SERVER_SMALL:
        want[len(requests), "raw"] = api.compress(data[a:b])
        requests.append(data[a:b])
    jobs = sorted(want)
    n = sum(len(requests[i]) for i, _k in jobs)
    print(f"server requests: {len(jobs)} compresses ({big} slices of "
          f"{SERVER_SLICE} bytes or the remainder, raw and framed under "
          f"{POLICIES}; {len(SERVER_SMALL)} raw below one block), {n} "
          f"bytes, then as many decompresses and one corrupt stream; "
          f"reference streams {time.perf_counter() - t0} s")
    _reset(wrappers)
    seconds = {}
    for label, make in _server_configs(dev).items():
        with make() as srv:
            streams, backs, bad, tc, td = _serve_mix(srv, requests, jobs)
            st = srv.stats
        if streams != want:
            wrong = sorted(k for k in want if streams[k] != want[k])
            raise AssertionError(f"server {label}: streams differ from the "
                                 f"API's / framing's: {wrong[:8]}")
        if backs.keys() != want.keys() or any(
                out != requests[i] for (i, _k), out in backs.items()):
            raise AssertionError(f"server {label}: a decode differs")
        if not isinstance(bad, ValueError):
            raise AssertionError(f"server {label}: the corrupt stream gave "
                                 f"{bad!r}")
        if set(st.waves_by_kind) != {"enc", "dec", "scd", "dcd"}:
            raise AssertionError(f"server {label}: wave kinds "
                                 f"{st.waves_by_kind}")
        seconds[label] = (tc, td)
        print(f"server {label}: compress {_rate(n, tc)}; decompress "
              f"{_rate(n, td)} [{card}]")
        print(f"  ServerStats: requests {st.requests}, units {st.units}, "
              f"waves {st.waves}, waves_by_kind {st.waves_by_kind}, "
              f"occupancy {st.occupancy}, latency ms "
              f"{st.latency_percentiles()}, spliced_fragments "
              f"{st.spliced_fragments}, host_fastpath {st.host_fastpath}")
    launches = _launches(wrappers)
    print(f"server launches: {launches}")
    missing = [k for k in SHARDED_PATH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"kernels the server did not run: {missing}")
    for wave in sorted({k.split(",")[0] for k in seconds}):
        for j, stage in enumerate(("compress", "decompress")):
            mean = {}
            for d in (1, 2):
                runs = [v[j] for k, v in seconds.items() if "shards" not in k
                        and k.startswith(f"{wave}, depth {d}")]
                mean[d] = sum(runs) / len(runs)
            print(f"server {stage}, {wave}: depth 1 {mean[1]} s, depth 2 "
                  f"{mean[2]} s (means of {len(runs)} turns each): depth 1 "
                  f"/ depth 2 = {mean[1] / mean[2]} [{card}]")


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of an earlier commit: time its "
                         f"{' and '.join(REDESIGNED)} beside this one's on "
                         "the captured main-path calls, then sweep the "
                         "scatters' tiles and ffill's chunk")
    opts = ap.parse_args()
    start = time.perf_counter()
    name, smi = _card()
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}")
    dev = torch.device("cuda", 0)

    # Phase 2: build every kernel from the sources, from scratch.
    from tpu_snappy_torch.ops.kernels import _build
    _build.lib(force_build=True)
    info = _build.build_info
    print(f"build: nvcc {info['seconds']} s -> {info['path']}")
    for line in info["ptxas"]:
        print(f"  {line}")

    check_kernels(dev)

    from tpu_snappy_torch import api
    modules = _kernel_modules()
    wrappers = {k: getattr(mod, k) for k, mod in modules.items()}
    data, comp, launches, peak = round_trip(dev, wrappers)
    check_goldens(data, comp)
    card = smi
    framed, framed_launches, framed_stats = framed_round_trips(
        data, wrappers, card)
    preset_launches = preset_round_trips(dev, data, wrappers, card)
    place_launches = placement_wave(dev, data, wrappers, card)
    mode_launches, corpus = resolve_modes(dev, data, comp, wrappers, card)
    launches = {k: n + framed_launches[k] + preset_launches[k]
                + place_launches[k] + mode_launches[k]
                for k, n in launches.items()}

    # Times on the card (the round trip above was the warm-up).
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    comp2 = api.compress(data, device="cuda")
    t1 = time.perf_counter()
    back2 = api.decompress(comp2, device="cuda")
    t2 = time.perf_counter()
    if comp2 != comp or back2 != data:
        raise AssertionError("second round trip differs from the first")
    print(f"compress: {t1 - t0} s, {len(data) / (t1 - t0) / 1e9} GB/s; "
          f"load average {os.getloadavg()} [{card}]")
    print(f"decompress: {t2 - t1} s, {len(data) / (t2 - t1) / 1e9} GB/s "
          f"[{card}]")
    print(f"peak device memory over the round trip: {peak} bytes "
          f"(wave {api.API_WAVE}) [{card}]")
    compress_memory(dev, data, card)
    captured, stages = traced_round_trip(dev, data, framed, corpus, card)
    scan_forms(dev, stages, card)
    tree_decompress(data, comp, card)
    report = check_main_path_calls(dev, captured, stages, card)
    if opts.parent:
        old = compare_parent(dev, captured, stages, opts.parent, card)
        compare_parent_decode(dev, corpus, card)
        tile_sweep(dev, captured, card)
        resolve_tile_sweep(dev, captured, card, old)
    parallel_and_surfaces(dev, data, comp, framed, framed_stats, wrappers,
                          card)
    serving_phase(dev, data, framed, wrappers, card)

    kernels = []
    for k, mod in modules.items():
        r = report[k]
        kernels.append({"name": k, "route": "cuda", "source": mod.SOURCE,
                        "replaces": _replaces(mod, k),
                        "launches": launches[k], "max_abs_err": r["err"],
                        "ms": r["ms"], "graph_ms": r["graph_ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library_graph_ms": r["library_graph_ms"],
                        "worst_library_ratio": _extreme(max, r["ratios"]),
                        "least_bound_share": _extreme(min, r["shares"])})
        if r["wide_at_fixed_k"]:
            kernels[-1]["wide_at_fixed_k"] = r["wide_at_fixed_k"]
        if r["wide"]:
            w = r["wide"]
            kernels[-1].update(wide_k=w["k"], wide_sticky=w["sticky"],
                               wide_graph_ms=w["graph_ms"],
                               wide_bound_ms=w["bound_ms"],
                               wide_bound_by=w["bound_by"],
                               wide_least_bound_share=_extreme(
                                   min, r["wide_shares"]))
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "tpu_snappy"))
    if foreign:
        raise AssertionError(f"the port imported {foreign}")
    print(f"chip_smoke.py: {time.perf_counter() - start} s from the start "
          f"of main(), the build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
