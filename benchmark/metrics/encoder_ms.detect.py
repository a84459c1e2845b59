"""ms a request in the encoder's trunk (encoder_trunk)."""

from benchmark import readers


def read(sl):
    return readers.stage_ms(sl, ("encoder_trunk",))
