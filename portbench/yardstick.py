"""The benchmark's yardstick: the card's published peaks and the least time
the card could take for a kernel's work, computed from shapes alone.

The bounds are copies of the arithmetic the port's on-card smoke script
used (``ssd_bound``, ``ssd_bwd_bound``, ``attention_bound``), frozen here so
that no change to the program can move them. Each returns the least time in
seconds: the larger of the operations at the bf16 tensor-core rate and the
bytes at the HBM rate.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
BF16_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12
# every operand the bounds count is bf16, the configurations' dtype
BF16_BYTES = 2

# the chunk the SSD bounds count at: the configuration's own (Mamba-2's
# published chunk_size), whatever chunk a kernel uses
SSD_CHUNK = 256


def _bound(ops: float, nbytes: float) -> float:
    return max(ops / BF16_FLOP_S, nbytes / HBM_BYTES_S)


def ssd_fwd_work(b: int, s: int, h: int, p: int, n: int
                 ) -> tuple[float, float]:
    """(operations, bytes) of one SSD scan forward: x, dt, a, B, C read
    once, y and the final state written once; C.B^T once per (row, chunk)
    on the lower triangle, M.X on the lower triangle, the inter-chunk C.h
    and the state update per head."""
    nbytes = (2 * b * s * h * p * BF16_BYTES + b * s * h * 4 + h * 4
              + 2 * b * s * n * BF16_BYTES + b * h * p * n * 4)
    c = SSD_CHUNK
    nc = -(-s // c)
    tri = c * (c + 1) // 2
    ops = (b * nc * tri * n * 2
           + b * h * nc * (tri * p * 2 + c * n * p * 2 + c * p * n * 2
                           + p * n * 2))
    return float(ops), float(nbytes)


def ssd_bwd_work(b: int, s: int, h: int, p: int, n: int
                 ) -> tuple[float, float]:
    """(operations, bytes) of one SSD scan backward with the training
    path's cotangent (gy only): x, gy, dt, a, B, C read once, dx, ddt, da,
    dB, dC written once; C.B^T and the two dCB products per (row, chunk) on
    the lower triangle; per head dM = gY.X^T and M^T.gY on the lower
    triangle, the chunk state and its adjoint, gY.hz, B.Dn^T and X.Dn, and
    the two passes over the state."""
    nbytes = (3 * b * s * h * p * BF16_BYTES + 2 * b * s * h * 4 + 2 * h * 4
              + 4 * b * s * n * BF16_BYTES)
    c = SSD_CHUNK
    nc = -(-s // c)
    tri = c * (c + 1) // 2
    ops = (b * nc * 3 * tri * n * 2
           + b * h * nc * (2 * tri * p * 2 + 5 * c * n * p * 2
                           + 2 * p * n * 2))
    return float(ops), float(nbytes)


def attention_work(b: int, sq: int, sk: int, h: int, kh: int, d: int,
                   backward: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one bidirectional attention call, bf16
    operands. Forward: the two products over every (query head, key) pair,
    4 D operations each, against Q, K, V read once and O written once.
    Backward: the five products (S, dP, dV, dK, dQ), 10 D a pair, against
    Q, K, V, O, dO read once and dQ, dK, dV written once."""
    pairs = b * h * sq * sk
    per_pair, q_like = (10, 4) if backward else (4, 2)
    ops = per_pair * d * pairs
    nbytes = BF16_BYTES * d * q_like * (b * sq * h + b * sk * kh)
    return float(ops), float(nbytes)


def least_seconds(work: tuple[float, float]) -> float:
    """The least time for (operations, bytes) on one card."""
    return _bound(*work)
