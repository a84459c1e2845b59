"""The whole render's share of the card's peak (moves rays_per_s)."""

from benchmark import readers


def read(sl):
    return readers.mfu(sl)
