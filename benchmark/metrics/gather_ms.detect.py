"""ms a request in the latent lookup (encoder_index)."""

from benchmark import readers


def read(sl):
    return readers.stage_ms(sl, readers.GATHER)
