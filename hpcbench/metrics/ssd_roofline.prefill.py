"""The SSD scan's bound time (``reference/work_hybrid.ssd_work``, frozen,
at the card's peaks) over its device time a call, in percent.  A call is
three device kernels (chunk state, state pass, chunk output): their
seconds are summed and divided by the chunk-output kernel's records, one
a call."""
from hpcbench import trace
from hpcbench.reference import work

CALL = "ssd_chunk_out_kernel"
STEPS = "ssd_(chunk_state|state_pass|chunk_out)_kernel"


def read(rec):
    seg = rec.get("trace")
    per_call = rec.get("work", {}).get("kernels", {}).get(CALL)
    if rec.get("kind") != "prefill" or not seg or per_call is None:
        return None
    secs = trace.records_matching(seg, STEPS)[0]
    n = trace.records_matching(seg, CALL)[1]
    if n == 0 or secs <= 0:
        return None
    return 100.0 * work.bound_seconds(*per_call) / (secs / n)
