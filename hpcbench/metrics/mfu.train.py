"""The window's train-step model FLOPs over its seconds at the bf16
peak, in percent."""
from hpcbench import readers


def read(rec):
    return readers.mfu(rec, "train")
