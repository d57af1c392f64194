"""Sub-byte weight packing (port of ``sparsebit_tpu/ops/packing.py``).

Two layouts, bit-identical to the JAX package's:

- the canonical fold layout ("column planes"): b-bit codes packed along the
  output (N) axis, ``byte[k, c]`` holds ``q[k, c + j*(N//p)]`` at bit
  ``j*b`` with ``p = 8//b``; 3-bit is a low2 (p=4) plus a high1 (p=8)
  plane. This is the checkpoint format.
- the row-pair serving layout: adjacent input rows (K) share a byte, the
  even row in the low nibble. ``s4r`` stores ``code - 8`` as a signed
  nibble (``pack_u4_rows(codes) ^ 0x88``); the W4A8 kernels decode it with
  an arithmetic shift and use ``zero - 8`` in their epilogue.
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
    """Pack integer codes q (K, N) in [0, 2^bits) along N (fold layout).

    Returns a dict of uint8 tensors: bits 8 -> {"w": (K, N)}, 4 -> {"w":
    (K, N//2)}, 2 -> {"w": (K, N//4)}, 3 -> {"low2": (K, N//4), "high1":
    (K, N//8)}."""
    K, N = q.shape
    q = q.to(torch.uint8)
    if bits == 8:
        return {"w": q}
    if bits in (4, 2):
        p = 8 // bits
        if N % p:
            raise ValueError("N={} not divisible by fold {}".format(N, p))
        planes = q.reshape(K, p, N // p)
        out = torch.zeros((K, N // p), dtype=torch.uint8, device=q.device)
        for j in range(p):
            out |= planes[:, j, :] << (j * bits)
        return {"w": out}
    if bits == 3:
        if N % 8:
            raise ValueError("3-bit packing needs N divisible by 8")
        low_planes = (q & 3).reshape(K, 4, N // 4)
        low2 = torch.zeros((K, N // 4), dtype=torch.uint8, device=q.device)
        for j in range(4):
            low2 |= low_planes[:, j, :] << (j * 2)
        high_planes = ((q >> 2) & 1).reshape(K, 8, N // 8)
        high1 = torch.zeros((K, N // 8), dtype=torch.uint8, device=q.device)
        for j in range(8):
            high1 |= high_planes[:, j, :] << j
        return {"low2": low2, "high1": high1}
    raise ValueError("unsupported bits: {}".format(bits))


def unpack_columns(packed, bits, N):
    """Inverse of pack_columns -> uint8 codes (..., K, N); leading axes (a
    layer stack) pass through. A 4-bit ``s4r``/``u4r`` row-pair container
    alone is unpacked too."""
    if bits == 8:
        return packed["w"]
    if bits == 4 and "w" not in packed:
        if "s4r" in packed:
            return unpack_s4_rows(packed["s4r"])
        if "u4r" in packed:
            return unpack_u4_rows(packed["u4r"])
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
