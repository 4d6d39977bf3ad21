"""The window's prefill model FLOPs over its seconds at the bf16 peak,
in percent."""
from hpcbench import readers


def read(rec):
    return readers.mfu(rec, "prefill")
