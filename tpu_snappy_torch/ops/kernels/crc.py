"""CRC-32C of every row of a block batch, on the card.

The framed container (framing.py) writes the masked CRC-32C of each 64 KB
chunk; its encoder has the chunks on the device already, as the rows it
encodes, so `crc32c_rows` computes the CRCs there, beside the encode.
The CUDA kernel is csrc/crc32c.cu. It replaces no TPU kernel: the JAX
package computes the container's CRC-32C on the host (numpy slice-by-8).

The algebra, shared by the kernel and the plain version: CRC-32C is
linear over GF(2) once its init and final xor are set aside. Let R0(m)
be the register a zero-initialised CRC leaves after the bytes m, a
polynomial mod P (P = 0x1EDC6F41, held bit-reflected as 0x82F63B78).
Then R0(a || b) = R0(a) * x^(8|b|) xor R0(b), and leading zero bytes do
not change R0. So a row splits into segments whose R0 is computed side
by side and combined with one multiplication each. A row of width W whose
bytes at or past n are taken as zero has R0 equal to R0(row[:n]) *
x^(8(W - n)); the init 0xFFFFFFFF adds 0xFFFFFFFF * x^(8n). Both fold into
crc = ((R0 xor 0xFFFFFFFF * x^(8W)) * x^(-8(W - n))) xor 0xFFFFFFFF:
one constant and one multiplication by an inverse power of x, which
exists because P has a constant term.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

N = 1 << 16
SOURCE = "tpu_snappy_torch/ops/kernels/csrc/crc32c.cu"

#: The reflected Castagnoli polynomial, and 1 (x^0) in its bit order.
POLY = 0x82F63B78
ONE = 0x80000000
#: x^-1 mod P, bit-reflected: the value whose product with x is 1.
X_INV = 0x05EC76F1

#: The kernel's layout (csrc/crc32c.cu: kThreads, kTables): a CTA of
#: THREADS threads a row, each on one SEG-byte segment, with slice-by-16
#: tables.
THREADS = 256
SEG = N // THREADS
TABLES = 16
#: Inverse powers x^(-8 * 2^j) for every bit of a shortfall W - n <= W.
INVERSES = 17

#: Bytes a segment of the plain version (more segments, fewer steps).
PLAIN_SEG = 64


def _times_x(b: int) -> int:
    return (b >> 1) ^ (POLY if b & 1 else 0)


def gf_mul(a: int, b: int) -> int:
    """a * b mod P, both bit-reflected."""
    p = 0
    for i in range(31, -1, -1):
        if (a >> i) & 1:
            p ^= b
        b = _times_x(b)
    return p


def _power(base: int, k: int) -> int:
    r = ONE
    while k:
        if k & 1:
            r = gf_mul(r, base)
        base = gf_mul(base, base)
        k >>= 1
    return r


def x_pow(k: int) -> int:
    """x^k mod P (k >= 0)."""
    return _power(_times_x(ONE), k)


def x_inv_pow(k: int) -> int:
    """x^-k mod P (k >= 0)."""
    return _power(X_INV, k)


@functools.lru_cache(maxsize=None)
def tables() -> tuple:
    """The slice-by-16 tables: table j maps a byte to R0 of that byte
    followed by j zero bytes (table 0 is the bytewise CRC table)."""
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = _times_x(c)
        t0.append(c)
    out = [t0]
    for _ in range(1, TABLES):
        prev = out[-1]
        out.append([(v >> 8) ^ t0[v & 0xFF] for v in prev])
    return tuple(tuple(t) for t in out)


def _shifts(seg: int) -> list:
    """x^(8 * seg * (count - 1 - s)) for each of the row's count segments
    of seg bytes: what moves segment s's R0 to the row's end."""
    count = N // seg
    step = x_pow(8 * seg)
    out = [ONE]
    for _ in range(count - 1):
        out.append(gf_mul(out[-1], step))
    return out[::-1]


@functools.lru_cache(maxsize=None)
def constants() -> tuple:
    """What the kernel reads, in its order (csrc/crc32c.cu kShiftAt,
    kInitAt, kInverseAt): the tables, every thread's shift, the init's
    term 0xFFFFFFFF * x^(8W), and x^(-8 * 2^j) for j < INVERSES."""
    flat = [v for t in tables() for v in t]
    init = gf_mul(0xFFFFFFFF, x_pow(8 * N))
    inverses = [x_inv_pow(8 << j) for j in range(INVERSES)]
    return tuple(flat + _shifts(SEG) + [init] + inverses)


@functools.lru_cache(maxsize=None)
def _constants_on(device: torch.device) -> torch.Tensor:
    """constants() as an int32 tensor on `device`, made once a device."""
    host = np.asarray(constants(), dtype=np.uint32).view(np.int32)
    return torch.from_numpy(host.copy()).to(device)


def _bits(c: int) -> list:
    return [(c >> i) & 1 for i in range(32)]


@functools.lru_cache(maxsize=None)
def _plain_matrices() -> tuple:
    """The plain version's GF(2) matrices, float32 (an output bit is a sum
    of at most 32768 ones, exact): (W / PLAIN_SEG * 32, 32) taking every
    segment's R0 bits to the row's end, and (INVERSES, 32, 32), the
    multiplications by x^(-8 * 2^j). Row i of a multiplication by c holds
    the bits of (1 << i) * c = c * x^(31 - i)."""
    def rows_of(c):
        out = []
        for _ in range(32):   # bit 31 first: (1 << 31) is 1
            out.append(_bits(c))
            c = _times_x(c)
        return out[::-1]

    shift = [r for c in _shifts(PLAIN_SEG) for r in rows_of(c)]
    inverse = [rows_of(c) for c in constants()[-INVERSES:]]
    return (torch.tensor(shift, dtype=torch.float32),
            torch.tensor(inverse, dtype=torch.float32))


def _unbits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 floats, each a sum mod 2 to come, packed to int64."""
    one = bits.to(torch.int64) & 1
    return (one << torch.arange(32, device=bits.device)).sum(-1)


def _to_bits(c: torch.Tensor) -> torch.Tensor:
    return ((c[..., None] >> torch.arange(32, device=c.device)) & 1).to(
        torch.float32)


def crc32c_rows_plain(blocks: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form, on the batch's device, vectorised across rows
    and their 64-byte segments: the bytes past each length zeroed, every
    segment's R0 by slice-by-8 at once, the segments combined by one GF(2)
    matrix, the init and the length folded in by the inverse powers (rows
    of full length skip them)."""
    dev = blocks.device
    batch = blocks.shape[0]
    if not batch:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    n = lengths.to(torch.int64).clamp(0, N)
    masked = torch.where(torch.arange(N, device=dev) < n[:, None], blocks,
                         torch.zeros((), dtype=torch.uint8, device=dev))
    words = (masked.reshape(-1, PLAIN_SEG).contiguous().view(torch.int32)
             .to(torch.int64) & 0xFFFFFFFF)
    t = torch.tensor(tables()[:8], dtype=torch.int64, device=dev)
    r = torch.zeros(words.shape[0], dtype=torch.int64, device=dev)
    for j in range(0, PLAIN_SEG // 4, 2):
        lo, hi = words[:, j] ^ r, words[:, j + 1]
        r = (t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF]
             ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24]
             ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF]
             ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24])
    shift, inverse = (m.to(dev) for m in _plain_matrices())
    r0 = _unbits(_to_bits(r).reshape(batch, -1) @ shift)
    c = r0 ^ constants()[TABLES * 256 + THREADS]
    short = N - n
    for j in range(INVERSES):
        take = ((short >> j) & 1).bool()
        if take.any():
            c = torch.where(take, _unbits(_to_bits(c) @ inverse[j]), c)
    return c ^ 0xFFFFFFFF


def crc32c_rows(blocks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """CRC-32C (unmasked, framing.crc32c's value) of the first lengths[i]
    bytes of every row of a (B, 65536) uint8 batch; lengths (B,) int32,
    clamped to [0, 65536]. Bytes past a row's length never count, whatever
    they hold. Returns (B,) int64 in [0, 2^32) on the batch's device. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    batch = blocks.shape[0] if blocks.dim() else 0
    _build.require(blocks, torch.uint8, (batch, N), "blocks")
    _build.require(lengths, torch.int32, (batch,), "lengths")
    if _build.on_cpu(blocks, lengths):
        return crc32c_rows_plain(blocks, lengths)
    _build.require_aligned("crc32c_rows", blocks)
    out = torch.empty(batch, dtype=torch.int64, device=blocks.device)
    if batch:
        rc = _build.lib().snk_crc32c_rows(
            blocks.data_ptr(), lengths.data_ptr(),
            _constants_on(blocks.device).data_ptr(), out.data_ptr(), batch,
            _build.stream())
        _build.check(rc, "crc32c_rows")
        crc32c_rows.launches += 1
    return out


crc32c_rows.launches = 0
