"""fabric_egress.roofline_pct: the least time of the traced steps' egress
work (``roofline.fabric`` at the card's peaks) over the device time of
``fabric_egress_kernel`` in the trace."""


def read(record):
    if record.trace is None:
        return None
    kernel_s = record.trace.device_s("fabric_egress_kernel")
    bound = record.counters.get("profiled_bound_s")
    return 100.0 * bound / kernel_s if kernel_s > 0 and bound else None
