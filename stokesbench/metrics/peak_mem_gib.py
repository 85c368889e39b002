"""The card's peak allocated memory over the warm-up and the window, GiB."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
