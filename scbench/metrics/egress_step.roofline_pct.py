"""egress_step.roofline_pct: the least time the card could take for the
window's egress steps (``roofline.fabric`` work at the card's peaks) as a
share of the window."""


def read(record):
    bound = record.counters.get("bound_s")
    return 100.0 * bound / record.window_s if bound else None
