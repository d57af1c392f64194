"""Sub-byte weight packing (port of ``sparsebit_tpu/ops/packing.py``).

Three layouts, bit-identical to the JAX package's:

- the canonical fold layout ("column planes"): b-bit codes packed along the
  output (N) axis, ``byte[k, c]`` holds ``q[k, c + j*(N//p)]`` at bit
  ``j*b`` with ``p = 8//b``; 3-bit is a low2 (p=4) plus a high1 (p=8)
  plane. This is the checkpoint format.
- the row-pair serving layout: adjacent input rows (K) share a byte, the
  even row in the low nibble. ``s4r`` stores ``code - 8`` as a signed
  nibble (``pack_u4_rows(codes) ^ 0x88``); the W4A8 kernels decode it with
  an arithmetic shift and use ``zero - 8`` in their epilogue.
- the plane-concat serving layout ``"pl"`` (true-width 2/3-bit): the fold
  planes as one array per linear, [low2 | high1] (K, 3N/8) at 3 bits and
  the fold array itself (K, N/4) at 2 bits.
"""

import torch


def pack_u4_rows(codes):
    """codes (..., K, N) in [0, 16) -> (..., K//2, N) uint8 row pairs,
    even row in the low nibble."""
    q = codes.to(torch.uint8)
    K = q.shape[-2]
    if K % 2:
        raise ValueError("pack_u4_rows: K must be even, got {}".format(K))
    rows = q.reshape(q.shape[:-2] + (K // 2, 2, q.shape[-1]))
    return rows[..., 0, :] | (rows[..., 1, :] << 4)


def unpack_u4_rows(u8r):
    """Inverse of pack_u4_rows -> (..., K, N) uint8 codes."""
    K2, N = u8r.shape[-2], u8r.shape[-1]
    lo = u8r & 15
    hi = u8r >> 4
    return torch.stack([lo, hi], dim=-2).reshape(u8r.shape[:-2] + (K2 * 2, N))


def pack_s4_rows(codes):
    """codes (..., K, N) in [0, 16) -> (..., K//2, N) uint8 row pairs of
    signed nibbles ``code - 8`` ((c - 8) & 0xF == c ^ 8 for 4-bit c)."""
    return pack_u4_rows(codes) ^ 0x88


def unpack_s4_rows(u8r):
    """Inverse of pack_s4_rows -> (..., K, N) uint8 unsigned codes."""
    return unpack_u4_rows(u8r ^ 0x88)


def pallas_n_pad(N, bits):
    """Columns of padding the JAX package adds so packed widths are 128-lane
    multiples; kept so a checkpoint's padded shapes carry over unchanged."""
    mult = {8: 128, 4: 256, 3: 1024, 2: 512}[bits]
    return (-N) % mult


def pack_columns(q, bits):
    """Pack integer codes q (..., K, N) in [0, 2^bits) along N (fold
    layout); leading axes (a layer stack) pass through.

    Returns a dict of uint8 tensors: bits 8 -> {"w": (K, N)}, 4 -> {"w":
    (K, N//2)}, 2 -> {"w": (K, N//4)}, 3 -> {"low2": (K, N//4), "high1":
    (K, N//8)}."""
    lead, N = q.shape[:-1], q.shape[-1]
    q = q.to(torch.uint8)

    def fold(codes, p, width):
        planes = codes.reshape(lead + (p, N // p))
        out = torch.zeros(lead + (N // p,), dtype=torch.uint8,
                          device=q.device)
        for j in range(p):
            out |= planes[..., j, :] << (j * width)
        return out

    if bits == 8:
        return {"w": q}
    if bits in (4, 2):
        p = 8 // bits
        if N % p:
            raise ValueError("N={} not divisible by fold {}".format(N, p))
        return {"w": fold(q, p, bits)}
    if bits == 3:
        if N % 8:
            raise ValueError("3-bit packing needs N divisible by 8")
        return {"low2": fold(q & 3, 4, 2), "high1": fold((q >> 2) & 1, 8, 1)}
    raise ValueError("unsupported bits: {}".format(bits))


def unpack_columns(packed, bits, N):
    """Inverse of pack_columns -> uint8 codes (..., K, N); leading axes (a
    layer stack) pass through. A 4-bit ``s4r``/``u4r`` row-pair container
    or a 2/3-bit ``"pl"`` plane concat alone is unpacked too."""
    if bits == 8:
        return packed["w"]
    if bits == 4 and "w" not in packed:
        if "s4r" in packed:
            return unpack_s4_rows(packed["s4r"])
        if "u4r" in packed:
            return unpack_u4_rows(packed["u4r"])
    if bits in (2, 3) and "pl" in packed and "w" not in packed \
            and "low2" not in packed:
        return unpack_planes_serving(packed["pl"], bits, N)
    if bits in (4, 2):
        p = 8 // bits
        w = packed["w"]
        mask = (1 << bits) - 1
        planes = [(w >> (j * bits)) & mask for j in range(p)]
        return torch.stack(planes, dim=-2).reshape(w.shape[:-1] + (N,))
    if bits == 3:
        low2, high1 = packed["low2"], packed["high1"]
        lead = low2.shape[:-1]
        low = torch.stack(
            [(low2 >> (j * 2)) & 3 for j in range(4)], dim=-2
        ).reshape(lead + (N,))
        high = torch.stack(
            [(high1 >> j) & 1 for j in range(8)], dim=-2
        ).reshape(lead + (N,))
        return low | (high << 2)
    raise ValueError("unsupported bits: {}".format(bits))


def pack_planes_serving(codes, bits):
    """The true-width serving concat of the fold planes (packing.py:221):
    3 bits -> (K, 3N/8) [low2 (K, N/4) | high1 (K, N/8)] columns; 2 bits ->
    the (K, N/4) fold array as it is."""
    packed = pack_columns(codes, bits)
    if bits == 3:
        return torch.cat([packed["low2"], packed["high1"]], dim=-1)
    if bits == 2:
        return packed["w"]
    raise ValueError("plane serving covers bits 2/3, got {}".format(bits))


def unpack_planes_serving(pl, bits, N):
    """Inverse of pack_planes_serving -> uint8 codes (..., K, N)."""
    if bits == 3:
        NP = N // 8
        return unpack_columns(
            {"low2": pl[..., :2 * NP], "high1": pl[..., 2 * NP:]}, 3, N)
    if bits == 2:
        return unpack_columns({"w": pl}, 2, N)
    raise ValueError("unsupported bits: {}".format(bits))
