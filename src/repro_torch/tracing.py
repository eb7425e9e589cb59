"""Host spans of the port's own work, recorded only when switched on.

A span is one named stretch of host time, ``Span(name, start_ns, end_ns,
parent)``: ``time.perf_counter_ns`` at its start and end, and ``parent``
the index (in the list ``take`` returns) of the span open around it, or
-1.  The recorder is one per process and starts off.  While off, ``span``
hands back one shared no-op context and records nothing.  ``enable()``
switches it on: each span is then kept in memory until ``take()`` and is
also a profiler range named ``repro_torch:<name>``, so that a
``torch.profiler`` trace shows it on the clock of the device's events.
Spans are opened and closed on one thread.

The spans sit where derived state is rebuilt or a commit fans out, never
on a path that runs when nothing changed:

- ``fabric.view_rebuild``: ``ShardedFabric.fabric_view`` re-deriving the
  stacked view after its memo missed, made of
  ``fabric.shard_extract`` (every host's resident shard brought to the
  table epoch), ``fabric.shard_views`` (one ``ShardView`` a row) and
  ``fabric.stack_views`` (the rows stacked on the device);
- ``fm.commit``: one table epoch of the FM: the mutation, the table's
  commit, the journal append and the BISnp publish;
- ``bus.quiesce``: ``BISnpBus.quiesce``, every queued event delivered to
  every host.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

PREFIX = "repro_torch:"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int


class _Recorder:
    def __init__(self):
        self.on = False
        self.spans: list[Span] = []
        self.open: list[int] = []     # indices of the spans not yet closed


_REC = _Recorder()
_OFF = contextlib.nullcontext()


def enable() -> None:
    _REC.on = True


def disable() -> None:
    _REC.on = False


def take() -> list[Span]:
    """The spans recorded since the last ``take``, in the order they
    started; the recorder keeps none of them."""
    if _REC.open:
        raise RuntimeError(f"{len(_REC.open)} span(s) still open")
    spans, _REC.spans = _REC.spans, []
    return spans


def span(name: str):
    """A context recording ``name`` while the recorder is on; the shared
    no-op context while it is off."""
    if not _REC.on:
        return _OFF
    return _Recording(name)


class _Recording:
    __slots__ = ("name", "index", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from torch.profiler import record_function
        self.range = record_function(PREFIX + self.name)
        self.range.__enter__()
        self.index = len(_REC.spans)
        parent = _REC.open[-1] if _REC.open else -1
        _REC.spans.append(Span(self.name, time.perf_counter_ns(), -1, parent))
        _REC.open.append(self.index)
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        _REC.open.pop()
        _REC.spans[self.index] = _REC.spans[self.index]._replace(end_ns=end)
        self.range.__exit__(*exc)
