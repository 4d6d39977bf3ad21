"""The MoE dispatch in prefill: assignments dropped (over their expert's
capacity, sent to the dump row) over assignments routed to this card's
experts, in percent, summed over every MoE call of the traced segment.
The program counts them while torch.profiler records
(``repro_torch.models.moe.dispatch_counts``); None where it has no such
counter or counted nothing."""


def read(rec):
    if rec.get("kind") != "prefill" or not rec.get("trace"):
        return None
    try:
        from repro_torch.models.moe import dispatch_counts
    except ImportError:
        return None
    c = dispatch_counts()
    if not c["routed"]:
        return None
    return 100.0 * c["dropped"] / c["routed"]
