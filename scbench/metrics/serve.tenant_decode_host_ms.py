"""serve.tenant_decode_host_ms: median host milliseconds of one tenant's
``registry.decode_step`` in ``ServeEngine.step`` (the port's span
``serve.decode``), recorded in the traced window after the profiler
stopped: the issue of the step's kernels, and the waits where the
device's launch queue is full."""
import statistics


def read(record):
    spans = record.spans.get("serve.decode")
    return 1e3 * statistics.median(spans) if spans else None
