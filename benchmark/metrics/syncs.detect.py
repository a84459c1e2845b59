"""Host-device syncs a request inside the program's scopes and spans."""

from benchmark import program_spans


def read(sl):
    return program_spans.syncs(sl)
