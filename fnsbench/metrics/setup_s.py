"""Seconds from process start to the first timed request: corpus and
pool made, index built, engine placed, each batch size warmed."""


def read(rec):
    return rec.setup_s
