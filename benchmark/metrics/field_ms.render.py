"""ms a view in the field MLP (model_inference and the stages in it)."""

from benchmark import readers


def read(sl):
    return readers.stage_ms(sl, readers.FIELD)
