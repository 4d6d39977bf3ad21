"""Device-idle ms a prefill batch in the traced segment's idle gaps whose
label (the latest-started host event spanning the gap) is one of the
program's spans (``repro_torch.core.scope``: a name that starts with
``SPAN_PREFIX``): idle time while the host ran the program's own code
between ops.  The segment keeps only its ten largest labels, so this is a
lower bound.  None where the program has no spans."""


def read(rec):
    seg = rec.get("trace")
    if rec.get("kind") != "prefill" or not seg or not seg.get("units"):
        return None
    try:
        from repro_torch.core.scope import SPAN_PREFIX
    except ImportError:
        return None
    secs = sum(s for name, s in seg.get("idle_gaps", ())
               if name.startswith(SPAN_PREFIX))
    return 1e3 * secs / seg["units"]
