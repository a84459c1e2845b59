"""The whole request's share of the card's peak (moves view_p95_ms)."""

from benchmark import readers


def read(sl):
    return readers.mfu(sl)
