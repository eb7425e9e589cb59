"""device.idle_pct.egress: share of a fabric cell's traced window in which
no kernel, copy or set ran on the card."""


def read(record):
    t = record.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
