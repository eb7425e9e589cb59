"""control.commit_to_step_ms: median milliseconds from a lifecycle call
(evict + admit, or revoke) to the end on the card of the first egress step
after it: the commit, its BISnp fan-out to every host (quiesce) and the
re-derivation of the stacked view that step needs."""
import statistics


def read(record):
    spans = record.spans.get("control.commit_to_step")
    return 1e3 * statistics.median(spans) if spans else None
