"""control.revoke_land_p95_ms: 95th percentile of milliseconds from a
``revoke_hwpid`` call until the revoked tenant's row first reads fully
denied on the card."""
from scbench.harness import percentile


def read(record):
    spans = record.spans.get("control.revoke_land")
    return 1e3 * percentile(spans, 95) if spans else None
