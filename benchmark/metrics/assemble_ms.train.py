"""Host ms a step in the trainer's batch assembly (the program's
batch_assemble span: view choice, rays and grid targets in numpy)."""

from benchmark import program_spans


def read(sl):
    return program_spans.span_ms(sl, "batch_assemble")
