"""Rays the trainer's batch assembly builds a step (the program's
assemble_rays counter); None where it counted none, as where the program
has no such counter or the trainer is not the NeRF one."""

from benchmark import program_spans


def read(sl):
    return program_spans.counter(sl, "assemble_rays") or None
