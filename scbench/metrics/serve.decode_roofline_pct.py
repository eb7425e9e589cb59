"""serve.decode_roofline_pct: the bytes the window's tenant decode steps
must move (``roofline.moe.decode_bytes`` plus the experts hit, counted on
the device) at the card's HBM bandwidth, as a share of the window."""


def read(record):
    bound = record.counters.get("decode_bound_s")
    return 100.0 * bound / record.window_s if bound else None
