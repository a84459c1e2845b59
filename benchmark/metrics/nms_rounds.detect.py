"""Greedy NMS rounds a request (the program's nms_rounds counter)."""

from benchmark import program_spans


def read(sl):
    return program_spans.counter(sl, "nms_rounds")
