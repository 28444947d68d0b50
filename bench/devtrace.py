"""The traced window: ``torch.profiler`` over the device only, read in
memory (no trace file is written).

The window opens with spin kernels, as ``chip_smoke.py``'s
``profiled_window`` does: the profiler has been seen to leave out the
first device records of a window, so a window counts only if it kept
one of its spins. From the device records: the busy time (the union of
every kernel, copy and set interval inside the window), device time by
name, and the idle gaps, each labelled by the host phase it overlaps
most (``probes.Phases``, on the host clock the profiler also uses)."""
from __future__ import annotations

import time

import torch

SPINS = 64
SPIN_CYCLES = 100_000
SPIN = "spin_kernel"


def _events(prof) -> list:
    """(name, start_ns, end_ns) of every device record."""
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns()))
    return out


class Window:
    """Run ``body()`` traced; raises when the profiler kept no spin."""

    def __init__(self, body):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            self.t0 = time.time_ns()
            self.result = body()
            torch.cuda.synchronize()
            self.t1 = time.time_ns()
        evs = _events(prof)
        self.spins_kept = sum(SPIN in n for n, _, _ in evs)
        if not self.spins_kept:
            raise RuntimeError(f"the profiler kept none of the window's "
                               f"{SPINS} spin kernels: its device records "
                               f"are incomplete")
        self.events = [(n, max(s, self.t0), min(e, self.t1))
                       for n, s, e in evs
                       if SPIN not in n and e > self.t0 and s < self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy(self) -> list:
        """The union of the device records as sorted intervals."""
        out: list = []
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def by_name(self) -> dict:
        """Seconds of device time by record name."""
        out: dict = {}
        for n, s, e in self.events:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def gaps(self) -> list:
        """(start_ns, end_ns) of every idle stretch of the window."""
        out, t = [], self.t0
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def idle_by_phase(self, marks: list) -> dict:
        """Idle seconds by the host phase each part of a gap fell in
        (``marks``: [(time_ns, phase)] transitions, in time order); idle
        time before the first mark is the harness's."""
        spans = [(self.t0, marks[0][0] if marks else self.t1, "harness")]
        spans += [(t, marks[i + 1][0] if i + 1 < len(marks) else self.t1,
                   p) for i, (t, p) in enumerate(marks)]
        out: dict = {}
        i = 0
        for gs, ge in self.gaps():
            while i < len(spans) and spans[i][1] <= gs:
                i += 1
            j = i
            while j < len(spans) and spans[j][0] < ge:
                s, e, p = spans[j]
                o = min(e, ge) - max(s, gs)
                if o > 0:
                    out[p] = out.get(p, 0.0) + o / 1e9
                j += 1
        return out
