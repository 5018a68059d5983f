"""Sub-byte bin-code packing — the device-resident compressed code matrix.

Port of `h2o3_tpu/ops/packing.py`. The host half (`pack_bits_for`,
`pack_host`, `pack_host_range`, `unpack_host`) is a numpy copy and must
stay byte-identical to
the reference; the device half (`unpack_device`, `packed_row_values`) is
torch. Layout: codes are packed ALONG ROWS in fixed groups so any row slice
at a group boundary unpacks standalone:

=====  ==========  ===========  =========================================
bits   rows/group  bytes/group  bitstream
=====  ==========  ===========  =========================================
4      2           1            row codes MSB-first, 4 bits each
5      8           5            row codes MSB-first, 5 bits each
6      4           3            row codes MSB-first, 6 bits each
=====  ==========  ===========  =========================================

Past 64 bins the matrix ships unpacked (`pack_bits_for` returns 0), and
past 256 bins `build_bins`' uint16 codes ship as int16 (`device_codes`).
"""

from __future__ import annotations

import numpy as np
import torch

# rows per pack group / packed bytes per group, by bit width
GROUP_ROWS = {4: 2, 5: 8, 6: 4}
GROUP_BYTES = {4: 1, 5: 5, 6: 3}


def device_codes(codes: np.ndarray) -> np.ndarray:
    """The code matrix as the device takes it: uint8 as it is; uint16 (more
    than 256 bins) viewed as int16, the same bits, since every code is below
    1024. torch.uint16 has no `gather` and no comparison on the CPU, while
    int16 has every op the tree path runs on both devices."""
    if codes.dtype == np.uint16:
        return codes.view(np.int16)
    if codes.dtype != np.uint8:
        raise TypeError(f"bin codes are uint8 or uint16, not {codes.dtype}")
    return codes


def pack_bits_for(nbins: int, nrows: int) -> int:
    """Narrowest usable packing for codes < nbins (0 = ship unpacked).
    Rows must be a multiple of the group size (padded row counts are
    multiples of 8)."""
    for bits, group in ((4, 2), (5, 8), (6, 4)):
        if nbins <= (1 << bits) and nrows % group == 0:
            return bits
    return 0


def packed_nrows(packed_rows: int, bits: int) -> int:
    """Unpacked row count of a packed array with `packed_rows` rows."""
    return packed_rows * 8 // bits


def pack_host(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack uint8 bin codes < 2^bits into `bits` bits per value along rows.
    bits ∈ {4, 5, 6}: {2, 8, 4} row-groups → {1, 5, 3} bytes."""
    if bits == 4:
        return (codes[0::2] << 4) | codes[1::2]
    if bits == 5:
        a, b, c, d, e, f, g, hh = (codes[i::8] for i in range(8))
        out = np.empty((5 * a.shape[0],) + codes.shape[1:], np.uint8)
        out[0::5] = (a << 3) | (b >> 2)
        out[1::5] = ((b & 0x3) << 6) | (c << 1) | (d >> 4)
        out[2::5] = ((d & 0xF) << 4) | (e >> 1)
        out[3::5] = ((e & 0x1) << 7) | (f << 2) | (g >> 3)
        out[4::5] = ((g & 0x7) << 5) | hh
        return out
    # 6-bit: stays uint8 end to end (max 63<<2 = 252)
    a, b, c, d = codes[0::4], codes[1::4], codes[2::4], codes[3::4]
    out = np.empty((3 * a.shape[0],) + codes.shape[1:], np.uint8)
    out[0::3] = (a << 2) | (b >> 4)
    out[1::3] = ((b & 0xF) << 4) | (c >> 2)
    out[2::3] = ((c & 0x3) << 6) | d
    return out


def pack_host_range(codes: np.ndarray, bits: int, r0: int, r1: int) -> np.ndarray:
    """Pack rows ``[r0, r1)`` of a full-width code matrix: one streamed
    block's bitstream (`models.block_store`), built from a view of its rows
    and never from a whole-matrix packed transient. `r0` and `r1` must sit
    on pack-group boundaries (block grids are multiples of 8 rows and every
    group size divides 8), so the block is byte-identical to the same slice
    of a whole-matrix `pack_host`."""
    group = GROUP_ROWS[bits]
    if r0 % group or r1 % group:
        raise ValueError(
            f"block [{r0}, {r1}) is not aligned to the {group}-row pack "
            f"group of {bits}-bit codes")
    return pack_host(codes[r0:r1], bits)


def unpack_host(packed: np.ndarray, bits: int) -> np.ndarray:
    """Inverse of `pack_host` on host numpy — bit-exact with
    `unpack_device`."""
    if bits == 4:
        k = packed.shape[0]
        out = np.empty((2 * k,) + packed.shape[1:], np.uint8)
        out[0::2] = packed >> 4
        out[1::2] = packed & 0xF
        return out
    if bits == 5:
        b = [packed[i::5].astype(np.uint16) for i in range(5)]
        k = packed.shape[0] // 5
        out = np.empty((8 * k,) + packed.shape[1:], np.uint8)
        out[0::8] = b[0] >> 3
        out[1::8] = ((b[0] & 0x7) << 2) | (b[1] >> 6)
        out[2::8] = (b[1] >> 1) & 0x1F
        out[3::8] = ((b[1] & 0x1) << 4) | (b[2] >> 4)
        out[4::8] = ((b[2] & 0xF) << 1) | (b[3] >> 7)
        out[5::8] = (b[3] >> 2) & 0x1F
        out[6::8] = ((b[3] & 0x3) << 3) | (b[4] >> 5)
        out[7::8] = b[4] & 0x1F
        return out
    b0 = packed[0::3].astype(np.uint16)
    b1 = packed[1::3].astype(np.uint16)
    b2 = packed[2::3].astype(np.uint16)
    k = packed.shape[0] // 3
    out = np.empty((4 * k,) + packed.shape[1:], np.uint8)
    out[0::4] = b0 >> 2
    out[1::4] = ((b0 & 0x3) << 4) | (b1 >> 4)
    out[2::4] = ((b1 & 0xF) << 2) | (b2 >> 6)
    out[3::4] = b2 & 0x3F
    return out


def unpack_device(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of `pack_host` on the packed tensor's device: (P, F) uint8
    words → (P·8/bits, F) uint8 codes."""
    if bits == 4:
        out = torch.stack([packed >> 4, packed & 0xF], dim=1)
        return out.reshape((2 * packed.shape[0],) + tuple(packed.shape[1:]))
    b = [packed[i::GROUP_BYTES[bits]].to(torch.int32)
         for i in range(GROUP_BYTES[bits])]
    if bits == 5:
        vals = [
            b[0] >> 3,
            ((b[0] & 0x7) << 2) | (b[1] >> 6),
            (b[1] >> 1) & 0x1F,
            ((b[1] & 0x1) << 4) | (b[2] >> 4),
            ((b[2] & 0xF) << 1) | (b[3] >> 7),
            (b[3] >> 2) & 0x1F,
            ((b[3] & 0x3) << 3) | (b[4] >> 5),
            b[4] & 0x1F,
        ]
    else:
        vals = [
            b[0] >> 2,
            ((b[0] & 0x3) << 4) | (b[1] >> 4),
            ((b[1] & 0xF) << 2) | (b[2] >> 6),
            b[2] & 0x3F,
        ]
    out = torch.stack(vals, dim=1).to(torch.uint8)
    return out.reshape((out.shape[0] * out.shape[1],) + tuple(packed.shape[1:]))


def packed_row_values(packed: torch.Tensor, rf: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """codes[i, rf[i]] as int32, read straight from the packed words — the
    per-row selected-feature code of the partition step. A row's code spans
    at most two adjacent bytes of its group's bitstream; two flat gathers
    and one shift recover it exactly (the second gather is clamped
    in-bounds and shifted out when the code sits in one byte)."""
    P, F = packed.shape
    n = P * 8 // bits
    i = torch.arange(n, dtype=torch.int64, device=packed.device)
    grp = i // GROUP_ROWS[bits]
    bit0 = (i % GROUP_ROWS[bits]) * bits
    b0 = grp * GROUP_BYTES[bits] + bit0 // 8
    off = bit0 % 8
    b1 = torch.clamp(b0 + 1, max=P - 1)
    flat = packed.reshape(-1)
    rfi = rf.to(torch.int64)
    v0 = flat[b0 * F + rfi].to(torch.int32)
    v1 = flat[b1 * F + rfi].to(torch.int32)
    return (((v0 << 8) | v1) >> (16 - bits - off).to(torch.int32)) & ((1 << bits) - 1)
