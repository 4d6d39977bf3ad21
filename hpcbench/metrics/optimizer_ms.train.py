"""Device ms a train step under the step's ``optimizer`` scope, in the traced
segment (kernels, copies and fills by the host call that launched them)."""
from hpcbench import readers


def read(rec):
    return readers.scope_ms(rec, "train", "optimizer")
