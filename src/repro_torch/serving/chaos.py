"""Deterministic chaos-schedule fault injection for the serving plane.

The plane's failure model is restart-class radiation events (SEFI, HBM
UECC) striking pods mid-generation.  A schedule is declarative:

  - `ChaosEvent(at_tick, pod, ticks)`: one strike.  At router tick >=
    `at_tick`, pod `pod` (None = the busiest pod at strike time, so the
    strike exercises failover) goes dark for `ticks` router ticks (None =
    the rest of the run).
  - `ChaosSchedule(events, ...)`: any number of events, overlapping or
    in sequence, plus an optional random strike process whose PRNG is
    seeded by (seed, tick): a replayed run regenerates the same outage
    history.

The schedule is immutable; which pod a `pod=None` event hit, and when,
lives in a dict the router owns, so one schedule can drive many planes
(a replicated plane and a full-drain plane on the same outage history).

`parse_outage_spec` is the launchers' grammar for the same thing:
`--force-outage-at "2:*:3,9:1:3"` strikes the busiest pod at tick 2 for
3 ticks, then pod 1 at tick 9 for 3 ticks.  A bare integer is a single
strike of the busiest pod for the rest of the run.

The port's copy of the reference's numpy-only module, line for line in
behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled strike.

    Fields:
      at_tick: earliest router tick at which the strike lands.
      pod: pod index to strike; None = the pod with the most in-flight
        slots at strike time (ties toward the lowest index). With
        pod=None the strike is deferred past `at_tick` until some pod
        has in-flight work — striking an idle plane exercises nothing.
      ticks: outage duration in router ticks from the actual strike;
        None = the rest of the run.
    """
    at_tick: int
    pod: Optional[int] = None
    ticks: Optional[int] = None


@dataclass(frozen=True)
class ChaosSchedule:
    """A declarative outage schedule for the serving grid.

    Fields:
      events: scheduled `ChaosEvent` strikes (any overlap allowed).
      random_rate: per-pod per-tick strike probability of an ADDITIONAL
        Poisson-like random process (0 = scheduled strikes only). Draws
        fold the PRNG on the tick index, so replays are bit-exact.
      random_ticks: outage duration of a random strike.
      seed: PRNG seed for the random process.

    `overlay(state, tick, alive, busy)` applies the schedule on top of a
    liveness mask. `state` is a mutable dict the CALLER owns (one per
    plane; seed it with `{}`): it records, per event index, which pod a
    strike resolved to and at which tick — the only mutable part of
    fault injection, kept outside the schedule so the schedule can be
    shared across planes and replays.
    """
    events: tuple = ()
    random_rate: float = 0.0
    random_ticks: int = 2
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for ev in self.events:
            if not isinstance(ev, ChaosEvent):
                raise TypeError(f"ChaosSchedule events must be ChaosEvent, "
                                f"got {type(ev).__name__}")
        if not 0.0 <= self.random_rate < 1.0:
            raise ValueError(f"random_rate must be in [0, 1), "
                             f"got {self.random_rate}")

    @property
    def has_repair(self) -> bool:
        """True if any struck pod ever comes back (finite-duration event
        or random strikes) — the schedules that exercise rejoin +
        rebalance, not just drain."""
        return (any(ev.ticks is not None for ev in self.events)
                or self.random_rate > 0)

    def overlay(self, state: dict, tick: int, alive, busy):
        """Apply the schedule at `tick` on top of `alive`.

        `busy` is the per-pod in-flight slot count (resolves pod=None
        strikes to the busiest pod). Returns a new alive array; `state`
        is updated in place with newly resolved strikes.
        """
        alive = np.array(alive, bool, copy=True)
        busy = np.asarray(busy)
        for k, ev in enumerate(self.events):
            rec = state.get(k)
            if rec is None and tick >= ev.at_tick:
                if ev.pod is not None:
                    rec = state[k] = (ev.pod, tick)
                elif busy.size and busy.max() > 0:
                    pod = int(max(range(busy.size),
                                  key=lambda i: (busy[i], -i)))
                    rec = state[k] = (pod, tick)
            if rec is not None:
                pod, t0 = rec
                if ev.ticks is None or tick < t0 + ev.ticks:
                    alive[pod] = False
        if self.random_rate > 0:
            n = alive.size
            for t in range(max(0, tick - self.random_ticks + 1), tick + 1):
                rng = np.random.default_rng((self.seed, t))
                alive &= ~(rng.random(n) < self.random_rate)
        return alive


def as_chaos_schedule(spec) -> Optional[ChaosSchedule]:
    """Normalize the router's `forced_outage` argument: a ChaosSchedule
    passes through, a `ForcedOutage` (the single-strike form) becomes a
    one-event schedule, None stays None."""
    if spec is None or isinstance(spec, ChaosSchedule):
        return spec
    # duck-typed ForcedOutage (avoids a circular import with router.py)
    if hasattr(spec, "at_tick"):
        return ChaosSchedule(events=(ChaosEvent(
            at_tick=spec.at_tick, pod=getattr(spec, "pod", None),
            ticks=getattr(spec, "ticks", None)),))
    raise TypeError(f"forced_outage must be a ForcedOutage or "
                    f"ChaosSchedule, got {type(spec).__name__}")


def parse_outage_spec(spec: str) -> ChaosSchedule:
    """Parse the CLI outage grammar into a ChaosSchedule.

    Grammar: comma-separated events, each `AT[:POD[:TICKS]]`:
      AT    — strike tick (int).
      POD   — pod index, or `*` (default) = busiest pod at strike time.
      TICKS — outage duration; omitted = rest of the run.

    `"3"`         -> a single strike (busiest pod, never repairs).
    `"2:*:3"`     -> busiest pod dark for ticks [strike, strike+3).
    `"2:0:3,6:1:3"` -> pod 0 then pod 1, two repair cycles.
    """
    events = []
    for part in str(spec).split(","):
        fields = part.strip().split(":")
        if not fields[0] or len(fields) > 3:
            raise ValueError(f"bad outage event {part!r} (want "
                             f"AT[:POD[:TICKS]])")
        at = int(fields[0])
        pod = None
        if len(fields) > 1 and fields[1] not in ("", "*"):
            pod = int(fields[1])
        ticks = None
        if len(fields) > 2 and fields[2] != "":
            ticks = int(fields[2])
            if ticks < 1:
                raise ValueError(f"outage duration must be >= 1 "
                                 f"({part!r})")
        events.append(ChaosEvent(at_tick=at, pod=pod, ticks=ticks))
    return ChaosSchedule(events=tuple(events))
