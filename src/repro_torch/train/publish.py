"""Rollback-aware publication of DiLoCo outer params to a serving sink.

The paper's deployment story is that the orbital cluster that trains also
serves ("continuous deployment"): between outer syncs the freshest
*verified* global params should be serving live traffic from the same
process. The hazard is fault tolerance: the DiLoCoSupervisor can roll a
round back (forced, or outer state suspect), and params produced by a
round that is later rolled back must NEVER reach the serving engine.

Verification horizon
--------------------
A whole-round rollback restores the supervisor's last host snapshot and
replays from there, so the snapshot round is the *watermark*: rounds at or
below it can never be rolled back again (snapshots are only taken of
state that passed the outer screens, and only advance forward). The
publisher therefore releases a staged candidate only once BOTH hold:

  - the supervisor's verified watermark (its snapshot round) has reached
    the candidate's round — the rollback-safety invariant, always on;
  - `holdback_rounds` further rounds have completed since the candidate —
    configurable extra margin, because the statistical SDC screens can
    only flag a corruption one round after the fact.

Any rollback drops every staged candidate above the restore point
(`stats["dropped_rollback"]`), and the supervisor never stages a round
that failed its outer screens in the first place — so the sink observes a
monotone sequence of verified rounds, trailing the training head by the
horizon.

The staged params come from `diloco.snapshot_global_params`: fresh device
tensors (no device-to-host copy) that stay valid however training moves
on, with shapes and dtypes identical across rounds — a
`ServingEngine.swap_params` sink casts them once and serves them with the
same kernels and shapes as before.
"""
from __future__ import annotations

from dataclasses import dataclass

from .diloco import snapshot_global_params


@dataclass(frozen=True)
class PublishConfig:
    """Publication cadence/horizon knobs.

    Fields:
      publish_every: stage a candidate every this many completed rounds
        (1 = every round boundary is a publish candidate).
      holdback_rounds: further completed rounds a candidate must survive
        (the screens run every round) before it may be served. This gate
        is relative to the training HEAD and is ANDed with the watermark
        gate: candidate r releases once
        r <= min(watermark, head - holdback_rounds).
    """
    publish_every: int = 1
    holdback_rounds: int = 1

    def __post_init__(self):
        if self.publish_every < 1:
            raise ValueError(f"publish_every must be >= 1, "
                             f"got {self.publish_every}")
        if self.holdback_rounds < 0:
            raise ValueError(f"holdback_rounds must be >= 0, "
                             f"got {self.holdback_rounds}")


# Enforced by `python -m repro_torch.analysis.lint --budgets` (entry
# "publish-snapshot"): the snapshot copy the publisher stages each round
# runs with zero host syncs — publication must never add a host
# round-trip to the training loop it rides on.
LINT_BUDGET = {"host_callbacks": 0}


class ParamPublisher:
    """Stages per-round param snapshots and releases them to `sink` only
    once they can no longer be rolled back.

    `sink(params)` is typically `ServingEngine.swap_params`; any callable
    taking the param tree works (tests use a recorder). Rounds are
    counted in "completed rounds" units, matching `DiLoCoSupervisor.round`
    and its snapshot round.
    """

    def __init__(self, sink, cfg: PublishConfig = PublishConfig()):
        self.sink = sink
        self.cfg = cfg
        self._staged = []            # [(round, params)], rounds increasing
        self.published_round = -1    # newest round the sink has received
        self.stats = {"staged": 0, "published": 0, "superseded": 0,
                      "dropped_rollback": 0}

    def on_round_complete(self, round_idx: int, d_state):
        """Stage the outer params after `round_idx` completed rounds.

        Must only be called for rounds that passed the outer screens (the
        supervisor's success path) — a failed round is rolled back, not
        staged. The snapshot is a device-to-device copy, so the round
        state can move on immediately."""
        if round_idx % self.cfg.publish_every:
            return
        self._staged.append((round_idx, snapshot_global_params(d_state)))
        self.stats["staged"] += 1

    def on_rollback(self, to_round: int):
        """Drop every candidate above the restore point: those rounds are
        about to be replayed (or were corrupt) and must never be served."""
        keep = [(r, p) for r, p in self._staged if r <= to_round]
        self.stats["dropped_rollback"] += len(self._staged) - len(keep)
        self._staged = keep

    def advance(self, head_round: int, verified_round: int) -> int | None:
        """Release the newest candidate inside the safe horizon.

        head_round: rounds completed so far; verified_round: the
        supervisor's snapshot watermark. A candidate r is safe when
        r <= min(verified_round, head_round - holdback_rounds). Older
        safe candidates are superseded (never served — the sink always
        jumps to the freshest verified params). Returns the published
        round, or None if nothing new cleared the horizon."""
        safe = min(verified_round, head_round - self.cfg.holdback_rounds)
        ready = [(r, p) for r, p in self._staged if r <= safe]
        if not ready:
            return None
        self._staged = [(r, p) for r, p in self._staged if r > safe]
        r, params = ready[-1]
        self.stats["superseded"] += len(ready) - 1
        self.stats["published"] += 1
        self.published_round = r
        self.sink(params)
        return r
