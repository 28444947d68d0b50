"""Spans of the port's own layers, on the device profiler's clock.

A span is a named host interval with its parent span, the trace id it
shares with every span of one query, and a few integer attributes.
``span(name)`` opens one as a context manager; ``RECORDER`` keeps the
closed spans in a list in memory as ``Span`` tuples, and its owner
takes them with ``take()`` when its window ends. Nothing is written to
disk.

Off is the default: ``span(...)`` then returns the one shared no-op
``OFF`` (one flag test, nothing allocated), so the sites below cost a
few attribute lookups a decode step. ``RECORDER.enable()`` turns it on
for a traced window and ``disable()`` off again.

Clock: ``time.perf_counter_ns()`` plus one offset to ``time.time_ns()``
read by ``enable``, the Unix-epoch clock ``torch.profiler``'s device
records are stamped on, so a device record or an idle gap of a
profiled window can be put down to the span open on the host at the
time. ``stamp_ns`` maps a ``time.perf_counter()`` stamp (a
``serving.scheduler.Request``'s) onto the same clock.

The spans of the port, innermost last:

* ``exec.query`` — ``Executor.execute``; its span id is the query's
  trace id, which ``SlotScheduler.submit`` stamps on each ``Request``;
* ``serving.request`` — one a finished request, written from the
  request's own submit and done stamps (attributes ``rid``, ``query``
  and ``queued_ns``, the submit-to-admit wait);
* ``serving.admit`` (``width``, ``tokens``) with ``serving.admit.upload``
  and ``serving.admit.prefill``; ``serving.round`` (``live``) with
  ``serving.round.launch``, ``serving.round.fetch`` and
  ``serving.round.harvest``;
* ``model.moe.route`` and ``model.moe.experts`` — ``_moe_local``, once a
  layer a step.

Following a slow verdict to its query:

1. Record a window: ``RECORDER.enable()`` before the queries,
   ``RECORDER.take()`` after (under ``torch.profiler`` to have the
   device records too).
2. The verdict's ``serving.request`` span: ``end_ns - start_ns`` is its
   submit-to-verdict time, ``queued_ns`` the part it waited for a slot,
   ``rid`` its request id.
3. Its ``trace`` (also its attribute ``query``) is the span id of the
   ``exec.query`` that submitted it: that span is the query, and every
   span with the same ``trace`` ran inside it.
4. The admission that served it is the ``serving.admit`` span holding
   ``start_ns + queued_ns`` (the request's admission stamp); its
   children split it into the upload and the prefill. The rounds that
   decoded it are the ``serving.round`` spans from that admission's end
   to the request's end; the last is the one whose
   ``serving.round.harvest`` holds ``end_ns``.
5. If ``queued_ns`` is most of the time, the verdict waited behind other
   requests for a slot; if not, its admission and rounds were slow, and
   the profiled window says why: each device record put down to the
   span open when it was launched, and the device's idle time inside
   each admission and round.
"""
from __future__ import annotations

import time
from typing import NamedTuple


class Span(NamedTuple):
    """One closed span: times in ns on the profiler's clock; ``parent``
    and ``trace`` are span ids, 0 for none."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent: int
    trace: int
    attrs: dict


class _Off:
    """The shared context manager ``span`` returns while off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value: int) -> None:
        """Attributes are not kept while off."""


OFF = _Off()


class _Open:
    """A span being recorded: opened by ``__enter__``, appended to its
    recorder's list by ``__exit__``."""

    __slots__ = ("rec", "name", "start", "span_id", "parent", "trace",
                 "attrs")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name, self.attrs = rec, name, {}

    def __enter__(self):
        rec = self.rec
        top = rec.stack[-1] if rec.stack else None
        rec.last_id += 1
        self.span_id = rec.last_id
        self.parent = top.span_id if top else 0
        self.trace = top.trace if top else self.span_id
        rec.stack.append(self)
        self.start = rec.now_ns()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        end = rec.now_ns()
        rec.stack.pop()
        rec.spans.append(Span(self.name, self.start, end, self.span_id,
                              self.parent, self.trace, self.attrs))
        return False

    def set(self, key: str, value: int) -> None:
        """Attach an integer attribute."""
        self.attrs[key] = int(value)


class Recorder:
    """The span list, the stack of open spans and the clock offset."""

    def __init__(self):
        self.on = False
        self.spans: list = []
        self.stack: list = []
        self.last_id = 0
        self.offset_ns = 0

    def enable(self) -> None:
        """Record from now on; reads the clock offset."""
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.on = True

    def disable(self) -> None:
        """Stop recording (spans open now are still recorded when they
        close)."""
        self.on = False

    def take(self) -> list:
        """The closed spans, in the order they closed; empties the
        list."""
        out, self.spans = self.spans, []
        return out

    def now_ns(self) -> int:
        """Now, on the profiler's clock."""
        return time.perf_counter_ns() + self.offset_ns

    def stamp_ns(self, perf_s: float) -> int:
        """A ``time.perf_counter()`` stamp on the profiler's clock."""
        return round(perf_s * 1e9) + self.offset_ns

    def span(self, name: str):
        """A context manager recording span ``name`` while on, else
        ``OFF``."""
        if not self.on:
            return OFF
        return _Open(self, name)

    def trace_id(self) -> int:
        """The trace id of the innermost open span, 0 outside any."""
        return self.stack[-1].trace if self.stack else 0

    def add(self, name: str, start_ns: int, end_ns: int, trace: int,
            **attrs) -> None:
        """Record a span that closed before now (its parent is its
        trace's root span)."""
        self.last_id += 1
        self.spans.append(Span(name, start_ns, end_ns, self.last_id,
                               trace, trace, attrs))


RECORDER = Recorder()
span = RECORDER.span
