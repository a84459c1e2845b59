"""ms a step in autograd's backward (every bwd: stage)."""

from benchmark import readers


def read(sl):
    return readers.backward_ms(sl)
