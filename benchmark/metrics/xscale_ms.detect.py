"""ms a request in cross_scale_padded (the program's span: the score
filter and its count sync, the float64 IoUs and the greedy rounds with
their looks); None where the program has no such span."""

from benchmark import program_spans


def read(sl):
    return program_spans.span_ms(sl, "cross_scale_padded")
