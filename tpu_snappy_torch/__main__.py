"""Command-line codec of the port (port of tpu_snappy/__main__.py).

Compresses and decompresses files through the port's codec on the CUDA
card (`--device cpu` runs it on the CPU instead), with optional mesh
sharding and streaming for large inputs.

  python -m tpu_snappy_torch compress   <in> <out> [--mesh N] [--stream]
  python -m tpu_snappy_torch decompress <in> <out> [--mesh N]
  python -m tpu_snappy_torch roundtrip  <in>      # verify + report ratio
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu_snappy_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("compress", "decompress", "roundtrip"):
        p = sub.add_parser(name)
        p.add_argument("infile", type=pathlib.Path)
        if name != "roundtrip":
            p.add_argument("outfile", type=pathlib.Path)
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="run on the CUDA card (the default; fails "
                            "when none is visible) or on the CPU")
        p.add_argument("--mesh", type=int, default=0,
                       help="shard over N devices (0 = single-device api)")
        p.add_argument("--framed", action="store_true",
                       help="Snappy framing format (chunked container "
                            "with per-chunk CRC-32C) instead of a raw "
                            "block stream")
        p.add_argument("--hadoop", action="store_true",
                       help="Hadoop SnappyCodec container (Spark/HDFS "
                            ".snappy block framing)")
        p.add_argument("--sidecar", choices=("off", "auto", "always"),
                       default="off",
                       help="framed fast-decode sidecar chunks (requires "
                            "--framed): 'auto' emits where the size cost "
                            "is small, 'always' trades stream size for "
                            "decode speed; foreign decoders skip them")
        p.add_argument("--fast", action="store_true",
                       help="speed-over-ratio encode preset "
                            "(config.FAST_CONFIG; round-trips stay "
                            "bit-exact)")
        p.add_argument("--turbo", action="store_true",
                       help="matched-ratio turbo encode preset "
                            "(config.TURBO_CONFIG; round-trips stay "
                            "bit-exact)")
        p.add_argument("--ultra", action="store_true",
                       help="maximum-speed encode preset "
                            "(config.ULTRA_CONFIG: turbo + stride-2 "
                            "anchors; round-trips stay bit-exact)")
        if name == "compress":
            p.add_argument("--stream", action="store_true",
                           help="wave-streamed encode (for huge inputs)")
            p.add_argument("--blocks-per-wave", type=int, default=64)
        if name == "decompress":
            p.add_argument("--stream", action="store_true",
                           help="wave-streamed framed decode (requires "
                                "--framed)")
    args = ap.parse_args(argv)

    from . import api, framing
    from .config import (DEFAULT_CONFIG, FAST_CONFIG, TURBO_CONFIG,
                         ULTRA_CONFIG)
    from .parallel import mesh as meshlib, shard, streaming

    if sum((args.fast, args.turbo, args.ultra)) > 1:
        ap.error("--fast/--turbo/--ultra are mutually exclusive presets")
    cfg = (ULTRA_CONFIG if args.ultra
           else TURBO_CONFIG if args.turbo
           else FAST_CONFIG if args.fast else DEFAULT_CONFIG)
    dev = args.device
    mesh = meshlib.make_mesh(args.mesh, device=dev) if args.mesh else None
    if args.framed and args.hadoop:
        ap.error("--framed and --hadoop are mutually exclusive containers")
    if args.sidecar != "off" and not args.framed:
        ap.error("--sidecar requires --framed (it rides skippable "
                 "framing chunks)")
    if args.hadoop:
        if args.mesh or getattr(args, "stream", False):
            ap.error("--hadoop composes with neither --mesh nor --stream "
                     "yet; use the framed container for those")
        from . import hadoop

        def compress_fn(d):
            return hadoop.compress(d, cfg=cfg, device=dev)

        def decompress_fn(c):
            return hadoop.decompress(c, device=dev)
    elif args.framed:
        # Framed chunks are independent, so the container composes with
        # mesh sharding and streaming directly.
        def compress_fn(d):
            return framing.compress(d, cfg, mesh, args.sidecar, device=dev)

        def decompress_fn(c):
            return framing.decompress(c, device=dev, mesh=mesh)
    else:
        # Without --mesh the raw stream is api.compress's, whose host path
        # below one block (and host fallback on decode) encode_dp and
        # decode_dp do not have, as in the JAX package's command line.
        def compress_fn(d):
            return (shard.encode_dp(d, mesh, cfg) if mesh
                    else api.compress(d, cfg, device=dev))

        def decompress_fn(c):
            return (shard.decode_dp(c, mesh) if mesh
                    else api.decompress(c, device=dev))

    if args.cmd == "compress":
        n = args.infile.stat().st_size
        t0 = time.perf_counter()
        if args.stream:
            with args.infile.open("rb") as src, args.outfile.open("wb") as dst:
                if args.framed:
                    out_n = framing.compress_stream(
                        src, dst, n, mesh, args.blocks_per_wave, cfg,
                        args.sidecar, device=dev)
                else:
                    stats = streaming.compress_stream(
                        src, dst, n, mesh,
                        blocks_per_wave=args.blocks_per_wave, cfg=cfg,
                        device=dev)
                    out_n = stats.out_bytes
        else:
            data = args.infile.read_bytes()
            comp = compress_fn(data)
            args.outfile.write_bytes(comp)
            out_n = len(comp)
        dt = time.perf_counter() - t0
        print(f"{n} -> {out_n} bytes (ratio {n / max(1, out_n):.3f}) "
              f"in {dt:.2f}s [{n / dt / 1e6:.1f} MB/s]")
    elif args.cmd == "decompress":
        if getattr(args, "stream", False):
            if not args.framed:
                ap.error("--stream decode requires --framed (independent "
                         "chunks; the raw stream needs its whole table)")
            n_in = args.infile.stat().st_size
            t0 = time.perf_counter()
            with args.infile.open("rb") as src, \
                    args.outfile.open("wb") as dst:
                n_out = framing.decompress_stream(src, dst, device=dev,
                                                  mesh=mesh)
            dt = time.perf_counter() - t0
            print(f"{n_in} -> {n_out} bytes in {dt:.2f}s "
                  f"[{n_out / dt / 1e6:.1f} MB/s]")
            return 0
        comp = args.infile.read_bytes()
        t0 = time.perf_counter()
        data = decompress_fn(comp)
        dt = time.perf_counter() - t0
        args.outfile.write_bytes(data)
        print(f"{len(comp)} -> {len(data)} bytes in {dt:.2f}s "
              f"[{len(data) / dt / 1e6:.1f} MB/s]")
    else:  # roundtrip
        data = args.infile.read_bytes()
        comp = compress_fn(data)
        back = decompress_fn(comp)
        ok = back == data
        print(f"{len(data)};{len(comp)};{'OK' if ok else 'MISMATCH'}")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
