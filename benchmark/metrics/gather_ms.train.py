"""ms a step in the latent lookup, forward and backward (encoder_index
and bwd:encoder_index)."""

from benchmark import readers


def read(sl):
    return readers.stage_ms(sl, readers.GATHER, backward=True)
