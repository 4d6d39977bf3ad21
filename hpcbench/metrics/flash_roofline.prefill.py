"""The flash kernel's bound time over its device time a call in prefill,
in percent."""
from hpcbench import readers


def read(rec):
    return readers.roofline(rec, "prefill", "flash_fwd_kernel")
