"""ms a request in nms_padded (the program's span: the greedy rounds,
their launches and sync waits)."""

from benchmark import program_spans


def read(sl):
    return program_spans.span_ms(sl, "nms_padded")
