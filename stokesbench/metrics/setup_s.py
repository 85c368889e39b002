"""Seconds from the start of the process to the first timed frame: imports,
the card, the kernel libraries, the inputs and the warm-up frames."""


def read(rec):
    return rec.setup_s
