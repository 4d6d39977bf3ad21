"""Device ms a prefill batch launched inside the program's Mamba-2 mixer
span (``rt.mamba``: the mixer with its input norm's output, its scan and
residual add) in the traced segment; None where the program has no such
span."""
from hpcbench import readers


def read(rec):
    return readers.scope_ms(rec, "prefill", "rt.mamba")
