"""Readings of the program's own spans (``repro_torch.trace``) against
the device records of a traced window, for the per-layer metrics of
the serving tier, the device and the model step.

They read a run's ``trace`` record under these keys, which only a
window with the span recorder on fills (``chip_spans.py`` makes such a
window today):

* ``spans`` — the recorder's ``Span`` tuples, (name, start_ns, end_ns,
  span_id, parent, trace, attrs);
* ``records`` — every device record of the window as (name, start_ns,
  end_ns, correlation), clipped to the window, spin kernels left out;
* ``launches`` — {correlation: start_ns} of the runtime calls that
  launched them;
* ``calls`` — every runtime call of the window as (name, start_ns,
  end_ns), for ``calls_in``;
* ``t0_ns``, ``t1_ns`` — the window's bounds.

All times are ns on the profiler's clock. Each reading returns None
when the run holds nothing for it to read (no such key, no such span).
"""
from __future__ import annotations

import bisect
import math

# written after the fact from a request's stamps, so it overlaps the
# spans that nest on the host's thread: it takes no kernels
AFTER_THE_FACT = ("serving.request",)


def _trace(run) -> dict:
    return (run.get("trace") or {}) if isinstance(run, dict) else {}


def named(run, name: str) -> list:
    """The run's spans called ``name``, by start."""
    return sorted((s for s in _trace(run).get("spans") or ()
                   if s[0] == name), key=lambda s: s[1])


def busy(records) -> list:
    """The union of ``records``' intervals, sorted."""
    out: list = []
    for _, s, e, _ in sorted(records, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(records, t0: int, t1: int) -> list:
    """(start, end) of every stretch of [t0, t1] no record covers."""
    out, t = [], t0
    for s, e in busy(records):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t1 > t:
        out.append((t, t1))
    return out


def overlap_ns(intervals, starts, s: int, e: int) -> int:
    """The part of [s, e] that the sorted, disjoint ``intervals`` cover
    (``starts``: their starts)."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    got = 0
    while i < len(intervals) and intervals[i][0] < e:
        got += max(0, min(e, intervals[i][1]) - max(s, intervals[i][0]))
        i += 1
    return got


def idle_ms(run, name: str):
    """Mean ms of device idle inside each span ``name``: the window's
    gaps intersected with the span."""
    tr, sp = _trace(run), named(run, name)
    if not sp or "records" not in tr:
        return None
    g = gaps(tr["records"], tr["t0_ns"], tr["t1_ns"])
    starts = [a for a, _ in g]
    return sum(overlap_ns(g, starts, s[1], s[2]) for s in sp) / len(sp) / 1e6


def mean_ms(run, name: str):
    """Mean host ms of span ``name``."""
    sp = named(run, name)
    return sum(s[2] - s[1] for s in sp) / len(sp) / 1e6 if sp else None


def p95(values):
    """The 95th percentile by nearest rank (None for no values)."""
    v = sorted(values)
    return v[math.ceil(0.95 * len(v)) - 1] if v else None


def queue_wait_p95_s(run):
    """95th percentile of the queued part (submit to admit) of every
    ``serving.request`` of the window, in s."""
    return p95([s[6]["queued_ns"] / 1e9
                for s in named(run, "serving.request")])


def innermost(spans, times) -> list:
    """For each of the ascending ``times``, the innermost of ``spans``
    open then (None outside all). ``spans`` nest (one host thread)."""
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            while stack and stack[-1][2] < order[i][1]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def kernel_spans(run) -> list:
    """Each device record of the window with the innermost span open
    when the host launched it: [(record, span or None)], records with
    no launch record left out."""
    tr = _trace(run)
    launches = tr.get("launches") or {}
    recs = sorted((r for r in tr.get("records") or ()
                   if r[3] in launches), key=lambda r: launches[r[3]])
    nested = [s for s in tr.get("spans") or ()
              if s[0] not in AFTER_THE_FACT]
    return list(zip(recs, innermost(nested,
                                    [launches[r[3]] for r in recs])))


def share(run, name: str):
    """% of the window's device busy time (the union of its records) in
    records whose launch was made with span ``name`` innermost."""
    tr = _trace(run)
    if not named(run, name) or not tr.get("launches"):
        return None
    total = sum(e - s for s, e in busy(tr["records"]))
    mine = sum(r[2] - r[1] for r, sp in kernel_spans(run)
               if sp is not None and sp[0] == name)
    return 100 * mine / total if total else None


def self_ns(spans) -> dict:
    """Each span's self time by span id: its duration minus the part of
    it that its children cover (spans written after the fact are no
    one's children)."""
    kids: dict = {}
    for s in spans:
        if s[0] not in AFTER_THE_FACT:
            kids.setdefault(s[4], []).append((s[1], s[2]))
    out = {}
    for s in spans:
        covered = busy([(None, a, b, None) for a, b in kids.get(s[3], ())])
        out[s[3]] = (s[2] - s[1]) - sum(b - a for a, b in covered)
    return out


def calls_in(run, name: str):
    """Where the host's time inside the spans ``name`` goes: for each
    runtime call name, the mean number and ms of such calls a span
    makes and the longest one (``calls``), and the mean ms a span
    spends in no runtime call (``outside_ms``: Python, the dispatcher,
    the allocator's host side)."""
    tr, sp = _trace(run), named(run, name)
    if not sp or not tr.get("calls"):
        return None
    calls = sorted(tr["calls"], key=lambda c: c[1])
    starts = [c[1] for c in calls]
    per: dict = {}
    inside = 0
    for s in sp:
        i = bisect.bisect_left(starts, s[1])
        while i < len(calls) and calls[i][1] < s[2]:
            d = min(calls[i][2], s[2]) - calls[i][1]
            c = per.setdefault(calls[i][0], [0, 0, 0])
            c[0], c[1], c[2] = c[0] + 1, c[1] + d, max(c[2], d)
            inside += d
            i += 1
    n = len(sp)
    return {"calls": {k: {"count": c[0] / n, "ms": c[1] / n / 1e6,
                          "max_ms": c[2] / 1e6} for k, c in per.items()},
            "outside_ms": (sum(s[2] - s[1] for s in sp) - inside) / n / 1e6}
