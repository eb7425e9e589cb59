"""fabric.step_host_ms: host milliseconds per ``ShardedFabric.step_egress``
call, mean over the window, less the time in the egress kernel's launch,
where the host waits while the device's launch queue is full: the view
lookup (after a commit its re-derivation), the operand checks and the
output's allocation."""


def read(record):
    spans = record.spans.get("fabric.step_egress")
    if not spans:
        return None
    launched = record.spans.get("fabric.launch", ())
    return 1e3 * (sum(spans) - sum(launched)) / len(spans)
