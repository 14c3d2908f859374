"""Dynamic-batching codec server (port of tpu_snappy/serving.py):
concurrent requests -> device waves.

Many callers compress and decompress at once, and the card wants batched
work. The server fans every request out into 64 KB work units (blocks to
encode, fragments or framed chunks to decode) and turns their arrival
into waves:

  caller threads --submit--> one unit queue per kind
        batcher thread --collect up to `wave` units of one kind, or
                         until the oldest unit has waited `max_wait_ms`-->
        one wave handed to a worker thread, each worker on its own CUDA
        stream; up to PIPELINE_DEPTH waves run at once, so waves of
        different kinds overlap on the card
        --per-unit results, oldest wave first--> request assembly
        --> caller futures

The JAX server dispatches a wave without waiting for the device and lets
the device queue overlap the waves. The port's encode and decode wait on
the host inside their own loops (the dense rounds' exit test, the parse's
entry scans), so a wave dispatched from the batcher thread would hold it
until the wave ends. Each wave therefore runs whole on a worker thread:
host packing, the kernels on the worker's stream and the copy back to
numpy. A host wait then blocks only its own wave. A wave returns numpy
arrays and bytes, never a device tensor, so every tensor of a wave is
allocated and freed on its worker's stream and the caching allocator needs
no record_stream.

Every wave runs through the sharded codec (parallel/shard.py) over the
server's mesh: without one, over one shard on `device`. A mesh dispatch
carries `wave` units per shard. Sub-block requests at DEFAULT_CONFIG skip
the queue and run on the host codec inline (api.SMALL_INPUT_BYTES).

Error isolation is per request: a corrupt stream fails its own future
(the same validation and host-fallback ladder as api.decompress), and its
neighbours in the same wave are unaffected, since fragments decode
independently. An exception in a wave fails the futures of that wave's
requests and no others. Nothing falls back to the CPU: a server on the
card raises where no card is visible, as the API does.

The results are the JAX server's bytes and exceptions for the same
requests and CodecConfig.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import threading
import time
from collections import deque

import numpy as np
import torch

from . import api
from . import format as fmt
from . import framing
from . import reference_codec
from . import sidecar as sc
from .config import CodecConfig, DEFAULT_CONFIG
from .ops import decode as ops_decode
from .parallel import shard


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    host_fastpath: int = 0
    units: int = 0
    waves: int = 0
    wave_slots: int = 0
    #: Dispatched waves per kind (enc/dec/scd/dcd).
    waves_by_kind: dict = dataclasses.field(default_factory=dict)
    #: Fragments re-decoded on the host because their device pass flagged
    #: them (fragment-granular fallback, not whole requests).
    spliced_fragments: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)

    @property
    def occupancy(self) -> float:
        """Mean fraction of wave slots carrying real work (1.0 = every
        dispatch was full: the arrival process kept the device fed)."""
        return self.units / self.wave_slots if self.wave_slots else 0.0

    def latency_percentiles(self, qs=(50, 95, 99)) -> dict:
        """Request latency (submit -> future resolution) percentiles in
        milliseconds, over device-batched requests (the host fast path is
        not tracked)."""
        if not self.latencies_s:
            return {f"p{q}": None for q in qs}
        arr = np.asarray(self.latencies_s)
        return {f"p{q}": round(float(np.percentile(arr, q)) * 1e3, 3)
                for q in qs}


class _Request:
    """One caller request fanned out into `n` work units.

    kind: 'enc'/'dec' (raw Snappy) or 'encf'/'decf' (framed container:
    the same waves, container assembly at completion)."""

    def __init__(self, kind: str, n: int, total: int):
        self.kind = kind
        self.t0 = time.monotonic()
        #: Enqueue time, set when the units reach the batcher queues. Wave
        #: ripeness keys off this, not t0: host prep before the enqueue
        #: (framed sidecar parsing) must not use up the max_wait window,
        #: or slow-prep requests would be born ripe and dispatch partial.
        self.tq = self.t0
        self.future: cf.Future = cf.Future()
        self.parts: list[bytes | None] = [None] * n
        self.missing = n
        self.total = total
        self.failed = False  # decode: some fragment failed device checks
        self.frags = None    # decode: (F, cap) uint8 for the host fallback
        self.clens = None
        self.ulens = None
        self.oks = [True] * n  # decode: per-unit device validation
        self.raw = None      # framed encode: original bytes (stores)
        self.crcs = None     # framed encode: each block's CRC-32C
        self.lengths = None  # framed encode: per-block uncompressed sizes
        self.sidecar = "off"  # framed encode: sidecar emission policy
        self.chunks = None   # framed decode: (type, body) data chunks
        self.chunk_ids = []  # framed decode: the data chunk of each unit

    def deliver(self, idx: int, part: bytes) -> bool:
        self.parts[idx] = part
        self.missing -= 1
        return self.missing == 0


class CodecServer:
    """Thread-safe compress/decompress service with dynamic batching.

    wave: work units (64 KB blocks, fragments or framed chunks) per
    dispatch, per shard when a mesh is given (a mesh dispatch carries
    wave x mesh.size slots).
    max_wait_ms: longest a unit waits for wave-mates before a partial
    wave dispatches anyway (the throughput/latency knob).
    mesh: a parallel.mesh.Mesh to serve over all its shards at once; its
    devices take the place of `device`. Without one, one shard on
    `device` ("cuda" by default, which raises where no card is visible;
    "cpu" runs the kernels' plain versions).
    max_pending: backpressure bound: submit calls block while this many
    work units are queued (None = unbounded). Units already handed to the
    workers do not count, so up to PIPELINE_DEPTH x wave x mesh.size
    in-flight units come on top of it.
    Use as a context manager, or call close()."""

    #: Waves in flight at once: one worker thread, and on the card one
    #: CUDA stream, each. Depth 2 overlaps a wave's host work (packing,
    #: the host waits inside the codec, the copy back) with another wave's
    #: kernels, also of another kind. The worker count is fixed at
    #: construction, so set it on a subclass to run at another depth; an
    #: instance's depth, assigned later, bounds the waves in flight but
    #: adds no worker.
    PIPELINE_DEPTH = 2

    def __init__(self, cfg: CodecConfig = DEFAULT_CONFIG, wave: int = 8,
                 max_wait_ms: float = 2.0, mesh=None,
                 max_pending: int | None = None, *, device="cuda"):
        self._cfg = cfg
        self._mesh = framing._mesh(device, mesh)
        self._wave = wave * self._mesh.size
        self._max_wait = max_wait_ms / 1e3
        self._max_pending = max_pending
        #: The first shard's device: on the card, each worker owns a
        #: stream on it (shards on other cards run on those cards'
        #: current streams).
        self._device = self._mesh.devices[0]
        self._tls = threading.local()
        self._lock = threading.Condition()
        # One queue per kind: encode, decode, root-map (0x80 sidecar) and
        # depth-hinted (0x81) decode differ, so a wave is single-kind.
        # Entries: (request, unit index, uncompressed length, *unit).
        self._q: dict[str, deque] = {"enc": deque(), "dec": deque(),
                                     "scd": deque(), "dcd": deque()}
        self._closing = False
        self.stats = ServerStats()
        self._pool = cf.ThreadPoolExecutor(
            max_workers=max(1, self.PIPELINE_DEPTH),
            thread_name_prefix="tpu-snappy-torch-wave")
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tpu-snappy-torch-batcher")
        self._worker.start()

    # ---- caller side ----

    def compress(self, data: bytes) -> cf.Future:
        """Future[bytes]: standard Snappy stream of `data`."""
        self._note_request()
        if len(data) < api.SMALL_INPUT_BYTES and self._cfg == DEFAULT_CONFIG:
            return self._host(api._host_compress, data)
        blocks, lengths = api._to_blocks(data, self._cfg.block_size)
        req = _Request("enc", len(lengths), len(data))
        self._enqueue(req, "enc", [(i, int(lengths[i]), blocks[i])
                                   for i in range(len(lengths))])
        return req.future

    def decompress(self, comp: bytes) -> cf.Future:
        """Future[bytes]: decoded payload; malformed input raises
        ValueError through the future (never synchronously)."""
        self._note_request()
        try:
            total, start = fmt.varint_decode(comp)
            if (total < api.SMALL_INPUT_BYTES
                    and self._cfg == DEFAULT_CONFIG):
                return self._host(self._host_decompress, comp)
            frags, clens, ulens = ops_decode.fragment_table(comp, start,
                                                            total)
        except ops_decode.FragmentFallback:
            return self._host(reference_codec.decompress, comp)
        except ValueError as e:
            return _failed(e)
        req = _Request("dec", len(ulens), total)
        req.frags, req.clens = frags, np.asarray(clens)
        req.ulens = np.asarray(ulens)
        self._enqueue(req, "dec", [(i, int(ulens[i]), frags[i],
                                    int(clens[i]))
                                   for i in range(len(ulens))])
        return req.future

    def compress_framed(self, data: bytes, sidecar: str = "off") -> cf.Future:
        """Future[bytes]: framed container stream (framing_format.txt:
        chunked, per-chunk CRC-32C). Blocks ride the same encode waves as
        raw requests, whose encode also gives each block's CRC-32C on the
        card; container assembly (the compressed-or-stored choice, the
        decode sidecars of `sidecar` as in framing.compress) happens at
        completion."""
        self._note_request()
        if not data:
            fut: cf.Future = cf.Future()
            fut.set_result(framing.STREAM_ID)
            return fut
        blocks, lengths = api._to_blocks(data, framing.MAX_CHUNK)
        req = _Request("encf", len(lengths), len(data))
        req.raw, req.lengths, req.sidecar = data, lengths, sidecar
        req.crcs = [None] * len(lengths)
        self._enqueue(req, "enc", [(i, int(lengths[i]), blocks[i])
                                   for i in range(len(lengths))])
        return req.future

    def decompress_framed(self, framed: bytes) -> cf.Future:
        """Future[bytes]: decoded framed stream with full validation
        (structure and every chunk CRC). Compressed chunks batch through
        the same fragment waves as raw decode requests; chunks with a
        usable 0x80 root map take the root-map wave kind and chunks with
        usable 0x81 depth hints the hinted kind, the chunk CRC gating the
        result either way."""
        self._note_request()
        try:
            chunks = framing._parse_chunks(framed)
        except ValueError as e:
            return _failed(e)
        datach = []   # (type, body) data chunks, in order
        side = []     # parallel: root-map payload bytes or None
        depth = []    # parallel: depth-hint payload bytes or None
        pend_s = pend_d = None
        for t, off, ln in chunks:
            body = framed[off: off + ln]
            if t == framing.CHUNK_SIDECAR:
                pend_s = body
            elif t == framing.CHUNK_DEPTH:
                pend_d = body
            elif t == framing.CHUNK_COMPRESSED:
                datach.append((t, body))
                side.append(pend_s)
                depth.append(pend_d)
                pend_s = pend_d = None
            elif t == framing.CHUNK_UNCOMPRESSED:
                datach.append((t, body))
                side.append(None)
                depth.append(None)
                pend_s = pend_d = None
        dec_units, scd_units, dcd_units, over_ids = [], [], [], []
        for i, (t, body) in enumerate(datach):
            if t != framing.CHUNK_COMPRESSED:
                continue
            try:
                ulen, vstart = fmt.varint_decode(body[4:])
            except ValueError as e:
                return _failed(ValueError(f"chunk {i}: {e}"))
            payload = body[4 + vstart:]
            if ulen > framing.MAX_CHUNK:
                return _failed(ValueError(
                    "chunk uncompressed size exceeds 65536"))
            sv = None
            if side[i] is not None and 0 < ulen and len(payload) < sc.OUT:
                parsed = sc.parse(side[i])
                if parsed is not None:
                    sv = sc.prep_parent(*parsed, int(ulen))
            dh = None
            if (sv is None and depth[i] is not None
                    and len(payload) <= ops_decode.FRAG_CAP):
                dh = sc.parse_depth(depth[i])
            arr = np.frombuffer(payload, np.uint8)
            if sv is not None:
                scd_units.append((i, int(ulen), payload) + tuple(sv))
            elif dh is not None:
                dcd_units.append((i, int(ulen), arr, len(payload), dh))
            elif len(payload) > ops_decode.FRAG_CAP:
                # Spec-valid but beyond the device fragment capacity (an
                # all-literal 64 KB chunk compresses to about 131 KB):
                # never enqueued, since no row of a wave can hold it. It
                # is marked not-ok, and _assemble_framed decodes it on the
                # host, as framing._decode_normal_chunks does.
                over_ids.append(i)
            else:
                dec_units.append((i, int(ulen), arr, len(payload)))
        n_units = (len(dec_units) + len(scd_units) + len(dcd_units)
                   + len(over_ids))
        req = _Request("decf", max(1, n_units),
                       sum(len(b) - 4 for _t, b in datach))
        req.chunks = datach
        if n_units == 0:
            # Stored or empty stream: settle inline (CRCs still checked).
            self._settle_framed(req)
            return req.future
        req.oks = [True] * n_units
        req.chunk_ids = ([u[0] for u in dec_units]
                         + [u[0] for u in scd_units]
                         + [u[0] for u in dcd_units] + over_ids)
        # Settle oversize chunks up front (host path at assembly); when
        # every unit is oversize this resolves the request inline.
        base = len(dec_units) + len(scd_units) + len(dcd_units)
        for j in range(len(over_ids)):
            req.oks[base + j] = False
            if req.deliver(base + j, b""):
                self._settle_framed(req)
                return req.future
        # Unit indices follow chunk_ids: dec, then scd, then dcd.
        units = {"dec": dec_units, "scd": scd_units, "dcd": dcd_units}
        with self._lock:
            self._ensure_open()
            self._wait_capacity()
            req.tq = time.monotonic()
            j = 0
            for kind, us in units.items():
                for u in us:
                    self._q[kind].append((req, j) + u[1:])
                    j += 1
            self._lock.notify_all()
        return req.future

    def close(self) -> None:
        """Drain the queues, then stop the batcher and the workers."""
        with self._lock:
            self._closing = True
            self._lock.notify_all()
        self._worker.join()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- internals: requests ----

    def _note_request(self):
        with self._lock:
            self.stats.requests += 1

    def _ensure_open(self):
        if self._closing:
            raise RuntimeError("CodecServer is closed")

    def _wait_capacity(self):
        """Backpressure: block the submitter while the unit queues hold
        max_pending units (called under self._lock)."""
        if self._max_pending is None:
            return
        while (sum(len(q) for q in self._q.values())
               >= self._max_pending):
            if self._closing:
                raise RuntimeError("CodecServer is closed")
            self._lock.wait(0.05)

    def _enqueue(self, req: _Request, kind: str, units: list) -> None:
        with self._lock:
            self._ensure_open()
            self._wait_capacity()
            req.tq = time.monotonic()
            self._q[kind].extend((req,) + u for u in units)
            self._lock.notify_all()

    def _resolve(self, req: _Request, result=None, exc=None):
        with self._lock:
            self.stats.latencies_s.append(time.monotonic() - req.t0)
        if exc is not None:
            req.future.set_exception(exc)
        else:
            req.future.set_result(result)

    def _host(self, fn, data) -> cf.Future:
        fut: cf.Future = cf.Future()
        try:
            fut.set_result(fn(data))
            with self._lock:
                self.stats.host_fastpath += 1
        except (ValueError, RuntimeError) as e:
            fut.set_exception(e)
        return fut

    def _host_decompress(self, comp: bytes) -> bytes:
        """api.decompress below one block: the host codec, with the
        empty-stream checks."""
        return api.decompress(comp, device=self._device)

    # ---- internals: the batcher ----

    def _take_batch(self, wait: bool = True):
        """Next ripe wave: a kind is ripe when it holds a full wave, its
        head unit has waited max_wait, or the server is draining. Returns
        (kind, units); (None, ()) = closed and drained; ("", ()) = nothing
        ripe right now (only when wait=False: _run passes that while waves
        are in flight, so it can spend the wait completing one)."""
        with self._lock:
            while True:
                now = time.monotonic()
                ripe = [k for k, q in self._q.items() if q and (
                    len(q) >= self._wave or self._closing
                    or q[0][0].tq + self._max_wait <= now)]
                if ripe:
                    # Prefer the fullest ripe kind (fair via FIFO heads).
                    kind = max(ripe, key=lambda k: len(self._q[k]))
                    break
                if self._closing and not any(self._q.values()):
                    return None, ()
                if not wait:
                    return "", ()
                heads = [q[0][0].tq + self._max_wait
                         for q in self._q.values() if q]
                self._lock.wait(max(1e-4, min(heads) - now)
                                if heads else 0.1)
            units = [self._q[kind].popleft()
                     for _ in range(min(self._wave, len(self._q[kind])))]
            self.stats.waves += 1
            self.stats.wave_slots += self._wave
            self.stats.units += len(units)
            self.stats.waves_by_kind[kind] = (
                self.stats.waves_by_kind.get(kind, 0) + 1)
            self._lock.notify_all()  # wake backpressured submitters
            return kind, units

    def _run(self):
        pending: deque = deque()  # (kind, units, worker future)
        while True:
            kind, units = self._take_batch(wait=not pending)
            if kind == "":
                # Nothing ripe: spend the wait on the oldest wave in
                # flight (its results are due before a new wave ripens).
                self._complete_one(pending)
                continue
            if kind is None:
                while pending:
                    self._complete_one(pending)
                return
            pending.append((kind, units,
                            self._pool.submit(self._run_wave, kind, units)))
            # max(1, ...): depth <= 0 would pop an empty deque and kill
            # the batcher thread (the knob is instance-assignable).
            while len(pending) >= max(1, self.PIPELINE_DEPTH):
                self._complete_one(pending)

    def _complete_one(self, pending: deque):
        """Wait for the oldest wave in flight and deliver its results, so
        completion stays in dispatch order. An exception in the wave, or
        in the assembly of its requests, fails that wave's requests."""
        kind, units, fut = pending.popleft()
        try:
            if kind == "enc":
                self._complete_encode(units, *fut.result())
            else:
                self._complete_decode(units, *fut.result())
        except Exception as e:  # noqa: BLE001 - the wave's futures get it
            for req, *_ in units:
                if not req.future.done():
                    self._resolve(req, exc=e)

    def _complete_encode(self, units, parts, crcs):
        for j, ((req, i, *_), part) in enumerate(zip(units, parts)):
            if req.kind == "encf":
                req.crcs[i] = int(crcs[j])
            if req.deliver(i, part):
                if req.kind == "encf":
                    self._resolve(req, self._assemble_framed_enc(req))
                else:
                    body = b"".join(req.parts)
                    self._resolve(req, fmt.varint_encode(req.total) + body)

    def _complete_decode(self, units, out: np.ndarray, ok: np.ndarray):
        for j, (req, i, ul, *_) in enumerate(units):
            if not ok[j]:
                # Exotic-but-valid (a cross-fragment copy) or corrupt.
                # Mark and keep counting units; the failed fragments (and
                # only those) re-decode on the host once all the request's
                # waves are in, and neighbours in this wave are unaffected.
                req.failed = True
                req.oks[i] = False
            if req.deliver(i, out[j, :ul].tobytes()):
                if req.kind == "decf":
                    self._settle_framed(req)
                elif req.failed:
                    self._settle_spliced(req)
                else:
                    self._resolve(req, b"".join(req.parts))

    # ---- internals: the waves (on the worker threads) ----

    @contextlib.contextmanager
    def _on_worker_stream(self):
        """The server's device, and this worker's own stream on it, made
        current for the wave: the kernels launch on the current device's
        current stream. Nothing on the CPU."""
        if self._device.type != "cuda":
            yield
            return
        stream = getattr(self._tls, "stream", None)
        if stream is None:
            stream = self._tls.stream = torch.cuda.Stream(self._device)
        with torch.cuda.device(self._device), torch.cuda.stream(stream):
            yield

    def _run_wave(self, kind: str, units):
        """One wave, whole: host packing, the sharded codec on the card
        and the copy back. Returns the element bytes of each block and
        their CRC-32C ("enc"), or numpy (out (n, 65536) uint8, ok (n,)
        bool)."""
        with self._on_worker_stream():
            if kind == "enc":
                return self._encode_wave(units)
            if kind == "scd":
                return self._sidecar_wave(units)
            return self._fragment_wave(units, hinted=kind == "dcd")

    def _encode_wave(self, units):
        """The element bytes of each block and, where the wave carries a
        framed request's block, each block's CRC-32C from the card (None
        in a wave of raw requests alone)."""
        blocks = np.stack([u[3] for u in units])
        lengths = np.asarray([u[2] for u in units], np.int32)
        framed = any(u[0].kind == "encf" for u in units)
        return framing._encode_blocks(blocks, lengths, self._mesh,
                                      self._cfg, crcs=framed)

    def _fragment_wave(self, units, hinted: bool):
        """The fragment decoder on a wave of fragments or framed chunks;
        hinted: the depth-hinted decoder on chunks with 0x81 hints (a
        wrong hint gives wrong bytes, which the chunk CRC catches in
        _assemble_framed: the hint is never trusted)."""
        clens = np.asarray([u[4] for u in units], np.int32)
        ulens = np.asarray([u[2] for u in units], np.int32)
        frags = np.zeros((len(units), ops_decode.frag_width(clens)),
                         np.uint8)
        for j, u in enumerate(units):
            frags[j, :u[4]] = u[3][:u[4]]
        arrays = (frags, clens, ulens)
        sharded = shard.decode_sharded
        if hinted:
            arrays += (np.stack([u[5] for u in units]).astype(np.int32),)
            sharded = shard.decode_depth_sharded
        return framing._decode_wave(
            len(units), lambda pad: framing._pad_rows(arrays, pad),
            self._mesh, sharded)[:2]

    def _sidecar_wave(self, units):
        """Root-map decode of framed chunks whose 0x80 sidecar parsed
        cleanly, at the widest window any of them needs. A False ok (or a
        CRC mismatch at assembly) sends the chunk to the host in
        _assemble_framed: the sidecar stays a hint."""
        wrows = max(u[6] for u in units)
        jobs = [(u[3], u[2], u[4], u[5]) for u in units]
        return framing._decode_wave(
            len(units), lambda pad: sc.pack_batch(jobs, pad_rows=pad),
            self._mesh, lambda m, e, s, v, u, w: shard.decode_sidecar_sharded(
                m, e, s, v, u, w, wrows))[:2]

    # ---- internals: request assembly ----

    def _assemble_framed_enc(self, req: _Request) -> bytes:
        """Framed container from the wave-encoded element bytes (the
        chunks framing.compress writes)."""
        return framing.STREAM_ID + framing._chunks(
            req.raw, req.lengths, req.parts, req.crcs, req.sidecar)

    def _settle_framed(self, req: _Request) -> None:
        try:
            self._resolve(req, self._assemble_framed(req))
        except ValueError as e:
            self._resolve(req, exc=e)

    def _assemble_framed(self, req: _Request) -> bytes:
        """Container decode for framed requests: every CRC verified; a
        device-flagged or CRC-mismatching compressed chunk re-decodes on
        the host (chunks are independent: no cross-chunk context)."""
        cid = {i: j for j, i in enumerate(req.chunk_ids)}
        out = []
        for i, (t, body) in enumerate(req.chunks):
            want = framing.unmask(int.from_bytes(body[:4], "little"))
            if t == framing.CHUNK_UNCOMPRESSED:
                piece = body[4:]
                if len(piece) > framing.MAX_CHUNK:
                    raise ValueError("uncompressed chunk exceeds 65536")
                crc = framing.crc32c(piece)
            else:
                j = cid[i]
                piece = req.parts[j] if req.oks[j] else None
                crc = framing.crc32c(piece) if piece is not None else None
                if crc != want:
                    try:
                        piece = reference_codec.decompress(body[4:])
                    except ValueError as e:
                        raise ValueError(f"chunk {i}: {e}") from e
                    crc = framing.crc32c(piece)
                    with self._lock:
                        self.stats.spliced_fragments += 1
            if crc != want:
                raise ValueError(f"chunk {i}: CRC-32C mismatch")
            out.append(piece)
        return b"".join(out)

    def _settle_spliced(self, req: _Request):
        """Fragment-granular host fallback: splice the ok fragments'
        device bytes and re-decode only the flagged ones in order, with
        the spliced prefix as copy context (api._splice_parts, as
        api.decompress does). Decodes valid-but-exotic streams; raises
        for corrupt ones."""
        try:
            result = api._splice_parts(req.frags, req.clens, req.ulens,
                                       req.parts, req.oks)
            if len(result) != req.total:
                raise ValueError(
                    f"invalid Snappy stream: decoded {len(result)} bytes, "
                    f"preamble said {req.total}")
            with self._lock:
                self.stats.spliced_fragments += req.oks.count(False)
            self._resolve(req, result)
        except (ValueError, IndexError) as e:
            self._resolve(req, exc=ValueError(str(e)))


def _failed(exc: BaseException) -> cf.Future:
    fut: cf.Future = cf.Future()
    fut.set_exception(exc)
    return fut
