"""The card's peaks and the candidate search's least time per batch.

Copied from ``chip_smoke.py`` (its ``WORK`` entry for ``cand_join`` and
its peaks), so the yardstick stays the benchmark's: a batch of B pairs
at the bucket (Lb, O) reads its 4-bit plane (Lb / 2 bytes a pair) and
both lengths (8 bytes a pair) once and writes the [B, C + 2] int16
candidate list once; its operations are one per k-mer emitted by either
read and one per candidate found. The candidates are not visible from
outside the program, so only the k-mers are counted (from the lengths):
an undercount of the operations, which only lowers the bound. Bytes set
the bound at every bucket of these cells.
"""

from __future__ import annotations

# H100 SXM data sheet, at the full 700 W power limit: device memory
# bandwidth; 32-bit integer add, compare, min, max and logic run on 64
# lanes per SM, a quarter of the 67 T/s float32 rate
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
C = 4  # candidates the list keeps per pair (ops/fused2.py)


def cand_bytes(B: int, Lb: int) -> int:
    return B * (Lb // 2 + 8 + 2 * (C + 2))


def cand_least_s(B: int, Lb: int, O: int, kmers: int) -> float:
    """The least time of one batch's candidate search: the larger of its
    bytes over the memory bandwidth and its operations over the 32-bit
    integer rate."""
    return max(cand_bytes(B, Lb) / HBM_BYTES_PER_S,
               kmers / INT32_OPS_PER_S)
