"""The CityBench stream of the ``citybench`` configuration, seeded.

CityBench (Ali, Gao & Mileo, ISWC 2015) replays smart-city sensor streams
from Aarhus; this generator keeps the two that kolibrie's cross-window
benchmark joins, traffic and parking, at the configuration's scale.  Road
``r`` reports one ``avgSpeed`` reading at each tick congruent to ``r``
modulo ``traffic_period``, its speed an integer drawn from the seed; lot
``l`` announces ``nearRoad road_{stride * l}`` at each tick congruent to
``l`` modulo ``parking_period``.  So every window of ``traffic_period``
ticks holds one reading of every road, and every window of
``parking_period`` ticks one announcement of every lot.  With fewer roads
than ``traffic_period`` (or lots than ``parking_period``) some ticks carry
no event on that stream, as a sensor network's quiet stretches do.

The same seed gives the same stream, tick by tick, for any tick: a tick's
speeds come from a generator keyed by the seed and the tick alone.  A
tick's events come in one order, the traffic readings by road, then the
parking announcements by lot; the loop pushes them so and the reference
counts them so (its control drops every 100th)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

SEED_MASK = (1 << 64) - 1

#: each stream's predicate, a local name under the window that holds it
TRAFFIC_PREDICATE = "avgSpeed"
PARKING_PREDICATE = "nearRoad"


class CityStream:
    def __init__(self, config: dict, seed: int):
        self.roads = int(config["roads"])
        self.lots = int(config["lots"])
        self.stride = int(config["lot_road_stride"])
        self.tp = int(config["traffic_period"])
        self.pp = int(config["parking_period"])
        self.lo = int(config["speed_min"])
        self.hi = int(config["speed_max"])
        self.seed = int(seed) & SEED_MASK
        self.traffic_iri = config["traffic_stream"]
        self.parking_iri = config["parking_stream"]
        if self.stride * (self.lots - 1) >= self.roads:
            raise ValueError("a lot is near a road that does not exist")

    def columns(self, tick: int) -> Dict[str, Tuple[np.ndarray, str, np.ndarray]]:
        """``tick``'s events by stream IRI, as term ids: ``(subjects,
        predicate, objects)``, in push order (:meth:`term` names an id)."""
        roads = np.arange(tick % self.tp, self.roads, self.tp)
        speeds = np.random.default_rng([self.seed, 1, int(tick)]).integers(
            self.lo, self.hi + 1, size=len(roads))
        lots = np.arange(tick % self.pp, self.lots, self.pp)
        return {
            self.traffic_iri: (roads, TRAFFIC_PREDICATE, self.roads + self.lots + speeds),
            self.parking_iri: (self.roads + lots, PARKING_PREDICATE, self.stride * lots),
        }

    def term(self, i: int) -> str:
        """The term of a subject or object id of :meth:`columns`: a road, a
        lot or a speed."""
        if i < self.roads:
            return f"road_{i}"
        if i < self.roads + self.lots:
            return f"lot_{i - self.roads}"
        return f'"{i - self.roads - self.lots}"'  # a speed: a plain literal

    def terms(self) -> List[str]:
        """Every term :meth:`columns` names, by id."""
        return [self.term(i) for i in range(self.roads + self.lots + self.hi + 1)]

    def events(self, tick: int) -> List[Tuple[str, str, str, str]]:
        """The events of ``tick`` in push order, each ``(stream IRI, s, p,
        o)`` with its terms as the stream carries them."""
        term = self.term
        return [(iri, term(x), p, term(y))
                for iri, (s, p, o) in self.columns(tick).items()
                for x, y in zip(s.tolist(), o.tolist())]

    def count(self, tick: int) -> int:
        """Events at ``tick``, both streams."""
        t, p = tick % self.tp, tick % self.pp
        return -(-(self.roads - t) // self.tp) + -(-(self.lots - p) // self.pp)
