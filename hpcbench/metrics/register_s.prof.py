"""Measurement set-up: seconds ``serve.register_steps`` took to export,
bind and register the steps (the sum of its per-step ``seconds``)."""


def read(rec):
    return (rec.get("spans") or {}).get("register_s")
