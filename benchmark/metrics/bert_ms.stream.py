"""Device milliseconds an image in BERT-base and its map to the
transformer's width (span gdino.bert), idle inside included."""
from benchmark.spans import per_unit_ms


def read(run):
    return per_unit_ms(run, ("gdino.bert",), "device_ms", "images")
