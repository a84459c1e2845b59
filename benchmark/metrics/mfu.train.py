"""The whole step's share of the card's peak (moves train_steps_per_s)."""

from benchmark import readers


def read(sl):
    return readers.mfu(sl)
