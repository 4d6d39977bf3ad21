"""The share of the measured prefill window in which the device ran
nothing: 1 - traced device busy seconds a batch / the window's seconds a
batch."""
from hpcbench import readers


def read(rec):
    return readers.idle_share(rec, "prefill")
