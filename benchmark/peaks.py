"""Published peaks of the card the cells run on (NVIDIA's data sheet, H100
SXM, at the full 700 W power limit; a run records the card's own limit
beside its numbers).  Only the bandwidth is read today: the casts' bound
counts bytes."""

H100_SXM = dict(hbm_bytes_per_s=3.35e12)
