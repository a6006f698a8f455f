"""The card's published HBM3 bandwidth (NVIDIA H100 SXM data sheet, at
its full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
