"""The share of the measured train window in which the device ran
nothing: 1 - traced device busy seconds a step / the window's seconds a
step."""
from hpcbench import readers


def read(rec):
    return readers.idle_share(rec, "train")
