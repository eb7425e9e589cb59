"""The general part of a run: find a cell's pieces by name, drive it,
read its metrics, judge it and print the result line.

A driver (``drivers/<driver>.py``) exposes ``run(ctx) -> RunRecord``.  It
sets the cell up, measures for ``ctx.seconds`` and judges what the timed
path produced against the plain reference.  Every per-layer metric has a
reader (``metrics/<metric>.py``) with ``read(record) -> float | None``;
``None`` leaves the metric out of the line.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import importlib.util
import itertools
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# the JAX package and JAX itself: none may be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# device seconds at most traced in a --trace 1 run (the trace of a long
# window is too large to read within a run's time)
TRACE_SECONDS = 2.0
TOP = 10


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def cell_params(name: str) -> dict:
    """The cell's own parameters: ``workloads/<cell>.json``."""
    return load_json(ROOT / "workloads" / f"{name}.json")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced.  A metric without a
    ``workloads`` key belongs to every cell (end to end), or to every cell
    that reports the end-to-end metric it moves (per layer)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py`` (names may hold dots)."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "scbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"scbench.drivers.{name}")


# ---------------------------------------------------------------------------
# what a run records
# ---------------------------------------------------------------------------

@dataclass
class TraceSummary:
    """The device side of the traced window, from the profiler."""
    window_s: float
    busy_s: float
    device_s_by_name: dict
    idle_s_by_host: dict

    def device_s(self, substring: str) -> float:
        """Device seconds of the operations whose name holds
        ``substring``."""
        return sum(s for n, s in self.device_s_by_name.items()
                   if substring in n)

    def breakdown(self) -> dict:
        top = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_s_by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in top[:TOP]],
                "idle_gaps": [[n, s] for n, s in gaps[:TOP]]}


@dataclass
class RunRecord:
    """What a driver hands back: the window, its counters, the harness's
    spans (traced run only), the trace summary (traced run only), the
    peak device memory, and the judged numbers with their limits."""
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    counters: dict = field(default_factory=dict)
    spans: dict = field(default_factory=lambda: defaultdict(list))
    trace: TraceSummary | None = None
    memory_peak_bytes: int = 0
    checks: dict = field(default_factory=dict)   # name -> (value, limit)
    setup_phases: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v <= lim for v, lim in self.checks.values())


class Spans:
    """Host spans around the calls into each layer, recorded in the traced
    run only (``enabled``): each span's seconds are kept by name, and the
    span is also a profiler range (``scbench:<name>``) so that idle device
    time can be put down to what the host was doing."""

    def __init__(self, record: RunRecord, enabled: bool):
        self.record = record
        self.enabled = enabled

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function("scbench:" + name):
            yield
        self.record.spans[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        """``fn`` inside a span of ``name`` (``fn`` itself when off)."""
        if not self.enabled:
            return fn

        def wrapped(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)
        return wrapped


class Tracer:
    """The profiler over the first ``TRACE_SECONDS`` of a traced window: it
    starts before the window (its start-up takes seconds on the card) and
    stops inside it."""

    def __init__(self, enabled: bool, sync):
        self.enabled = enabled
        self.sync = sync
        self.prof = None
        self.window = None
        self.active = False

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.sync is not None:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.window = record_function("scbench:window")
        self.window.__enter__()
        self.active = True

    def stop(self) -> float:
        """End the trace once the device has finished what was issued;
        returns the seconds the profiler then took to stop, in which the
        host issued nothing."""
        if not self.active:
            return 0.0
        if self.sync is not None:
            self.sync()
        t = time.perf_counter()
        self.window.__exit__(None, None, None)
        self.prof.stop()
        self.active = False
        return time.perf_counter() - t

    def summary(self) -> TraceSummary | None:
        if self.prof is None:
            return None
        return summarize(self.prof.events())


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _SpanIndex:
    """Harness spans sorted by start, for finding the innermost one that
    holds an instant: the latest-starting span that has not ended (spans
    nest or are disjoint)."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [sp[0] for sp in self.spans]
        self.max_end = list(itertools.accumulate(
            (sp[1] for sp in self.spans), max))

    def label(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.max_end[i] >= t:
            if self.spans[i][1] >= t:
                return self.spans[i][2]
            i -= 1
        return "outside harness spans"


def summarize(events) -> TraceSummary:
    """Busy and idle device time of the traced window (the
    ``scbench:window`` range), device time by operation, and idle device
    time by what the host was doing: each idle gap is put down to the
    innermost harness span that holds its midpoint."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    win = None
    spans, dev = [], []
    by_name = defaultdict(float)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # a harness range shows on the device timeline too: not work
            if not e.name.startswith("scbench:"):
                dev.append((s, t))
                by_name[e.name] += (t - s) * 1e-6
        elif e.name == "scbench:window":
            win = (s, t)
        elif e.name.startswith("scbench:"):
            spans.append((s, t, e.name[len("scbench:"):]))
    if win is None:
        raise RuntimeError("the traced window left no range in the trace")
    index = _SpanIndex(spans)
    w0, w1 = win
    busy = _merge([(max(s, w0), min(t, w1)) for s, t in dev
                   if t > w0 and s < w1])
    busy_us = sum(t - s for s, t in busy)
    idle = defaultdict(float)
    cursor = w0
    for s, t in busy + [[w1, w1]]:
        if s > cursor:
            idle[index.label((cursor + s) / 2)] += (s - cursor) * 1e-6
        cursor = max(cursor, t)
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                        device_s_by_name=dict(by_name),
                        idle_s_by_host=dict(idle))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

@dataclass
class Context:
    """Everything a driver gets: the cell, its configuration and
    parameters, the run's arguments, and hooks a test may set."""
    cell: str
    config: dict
    params: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    record: RunRecord
    spans: Spans
    control: str | None = None
    # tests only: wraps the timed step (``wrap_step(step) -> step``)
    wrap_step: object = None
    log: object = print

    def phase(self, name: str) -> None:
        """Stamp the end of a set-up phase (seconds since the process
        started), logged to standard error."""
        self.record.setup_phases[name] = time.perf_counter() - self.t_start
        self.log(f"setup {name}: {self.record.setup_phases[name]:.3f} s")


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), interpolated linearly between the
    sorted values (``statistics.quantiles``' inclusive method)."""
    vals = sorted(values)
    x = (len(vals) - 1) * q / 100
    lo = int(x)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (x - lo)


def run_cell(cell: str, *, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: str | None = None,
             overrides: dict | None = None, wrap_step=None,
             log=print) -> tuple[RunRecord, dict]:
    """Run one cell once; return its record and its result line."""
    bench = benchmark()
    entry = cell_entry(bench, cell)
    cfg_entry = config_entry(bench, entry["config"])
    config = load_json(REPO / cfg_entry["file"])
    params = cell_params(cell)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        params = {**params, **overrides.get("params", {})}
    record = RunRecord()
    ctx = Context(cell=cell, config=config, params=params, seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  t_start=t_start, record=record,
                  spans=Spans(record, trace), control=control,
                  wrap_step=wrap_step, log=log)
    driver(params["driver"]).run(ctx)
    metrics = {}
    for m in metrics_for(bench, cell, trace):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": record.correct, "attempted": record.attempted,
            "failed": record.failed, "metrics": metrics}
    return record, line


def loaded_forbidden() -> list[str]:
    import sys
    tops = {name.split(".")[0] for name in sys.modules}
    return sorted(tops & set(FORBIDDEN_MODULES))


def device_info(record: RunRecord, chips: int) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": record.memory_peak_bytes,
            "power_limit_w": power_limit_w()}
    if record.trace is not None:
        info["busy_s"] = record.trace.busy_s
        info["window_s"] = record.trace.window_s
    return info


def power_limit_w():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=30).stdout.strip()
        return float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def result_line(record: RunRecord, line: dict, device: dict) -> dict:
    """The printed line: ``line`` from ``run_cell``, then ``device``,
    ``breakdown`` (traced), and last the numbers compared with their
    limits."""
    out = dict(line, device=device)
    if record.trace is not None:
        out["breakdown"] = record.trace.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in record.checks.items()}
    return out


def checks_text(record: RunRecord) -> list[str]:
    return [f"check {name}: {value} (limit {limit})"
            for name, (value, limit) in record.checks.items()]

