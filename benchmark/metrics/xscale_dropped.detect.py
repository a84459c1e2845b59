"""Boxes a request that the cross-scale pass removed (the program's
xscale_dropped counter); None where the program has no cross_scale_padded
span."""

from benchmark import program_spans


def read(sl):
    if program_spans.span_ms(sl, "cross_scale_padded") is None:
        return None
    return program_spans.counter(sl, "xscale_dropped")
