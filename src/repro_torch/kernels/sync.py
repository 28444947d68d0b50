"""Device→host synchronisation accounting for the kernel layer.

Every host-facing kernel wrapper that materialises device results
(``group_build``, ``group_build_columns``, ``segment_reduce_host``,
``expand_segments``) ticks the global counter once per device→host
fetch, tagged with the site that fetched. Wrappers that *fall back* to
host-side numpy (the ``impl="host"`` oracle paths: ``np.unique`` code
assignment, ``np.repeat`` expansion) record a *fallback* instead — so
tests can assert that the accelerated path performs zero host-side
numpy, and the microbenchmarks can report both counts in their
BENCH_*.json artifacts. Removed round-trips stay visible because the
cost model's fidelity to the executor depends on the executor not
hiding host bounces (Larch's placement-vs-executor drift argument).
"""
from __future__ import annotations

from dataclasses import dataclass, field

# serving-tier sync sites (see docs/serving.md and the port's
# serving/scheduler.py): these count the LLM tier's host waits on the
# device, which scale with decode length — the executor reports them
# separately (``ExecStats.serving_syncs``) so the data-path budget
# ``pipeline_syncs`` stays comparable across serving disciplines
# (drained ticks per decode *step*, continuous per *round* and per
# admission batch, whose upload from pageable memory waits for the
# queued device work)
SERVING_SITES = ("serving_round", "serving_decode", "serving_admit")


@dataclass
class HostSyncStats:
    """Global device→host fetch / host-fallback counters.

    ``syncs`` counts device→host fetches (one per host-facing kernel
    wrapper call on an accelerated impl); ``by_site`` breaks the same
    count down by wrapper name. ``host_fallbacks`` counts, per site,
    how often a wrapper served the request with host-side numpy instead
    of a device pass (``impl="host"`` — zero device fetches, but host
    ``np.unique``/``np.repeat`` work the accelerated path must avoid).

    ``collectives`` counts cross-device exchanges (one per collective
    launched by the partitioned data tier — the all-to-all behind a
    partition, the gathered partials of a sharded reduce), broken down
    by exchange site in ``by_collective``; they are the mesh analogue
    of ``syncs`` and feed ``ExecStats.collective_ops`` the same way
    ``pipeline_syncs`` is fed (see docs/sharding.md).
    """

    syncs: int = 0
    by_site: dict = field(default_factory=dict)
    host_fallbacks: dict = field(default_factory=dict)
    collectives: int = 0
    by_collective: dict = field(default_factory=dict)

    def tick(self, n: int = 1, site: str | None = None) -> None:
        """Record ``n`` device→host fetches, attributed to ``site``."""
        self.syncs += n
        if site is not None:
            self.by_site[site] = self.by_site.get(site, 0) + n

    def site_total(self, sites) -> int:
        """Sum of ``by_site`` counts over ``sites`` (e.g. the serving
        tier's ``SERVING_SITES``)."""
        return sum(self.by_site.get(s, 0) for s in sites)

    def fallback(self, site: str, n: int = 1) -> None:
        """Record ``n`` host-side numpy servings of ``site``'s request."""
        self.host_fallbacks[site] = self.host_fallbacks.get(site, 0) + n

    def collective(self, site: str, n: int = 1) -> None:
        """Record ``n`` cross-device exchanges launched at ``site``
        (registered in ``tools/sal/registry.py::COLLECTIVE_SITES``)."""
        self.collectives += n
        self.by_collective[site] = self.by_collective.get(site, 0) + n

    def collective_total(self, sites) -> int:
        """Sum of ``by_collective`` counts over ``sites``."""
        return sum(self.by_collective.get(s, 0) for s in sites)

    def reset(self) -> None:
        """Zero every counter (benchmarks call this between paths)."""
        self.syncs = 0
        self.by_site = {}
        self.host_fallbacks = {}
        self.collectives = 0
        self.by_collective = {}

    def snapshot(self) -> dict:
        """JSON-ready copy of all counters for bench artifacts."""
        return {
            "syncs": self.syncs,
            "by_site": dict(self.by_site),
            "host_fallbacks": dict(self.host_fallbacks),
            "collectives": self.collectives,
            "by_collective": dict(self.by_collective),
        }


HOST_SYNCS = HostSyncStats()
