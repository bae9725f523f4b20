"""Staged weight rollout: shadow → canary → fleet, with auto-rollback.

A tuner challenger that wins the planner's WEIGHTS slot has only been
validated in *shadow* — seeded rollouts of the forecast horizon.  This
module is the path from shadow to the fleet, one stage at a time:

  ``SHADOW``   the planner scored the challenger against the incumbent
               in the same evaluator call (``mpc/planner.py``) — a win
               there is what calls :meth:`WeightRollout.propose`;
  ``CANARY``   the vector is applied to ONE live session's policy
               (``Policy.apply_weights`` — an attribute swap) and
               the governed tier's windowed p99 is watched for
               ``canary_checks`` decision windows;
  ``FLEET``    promotion applies the vector to every pool policy, then
               keeps watching for ``watch_checks`` windows before the
               vector becomes the new incumbent.

A p99 regression beyond ``regression_factor`` × the pre-rollout
reference at ANY watched stage rolls every touched policy back to the
saved incumbent in the same control-loop tick — automatic, logged, and
counted.  Every transition lands in :attr:`events`, on the service
trace timeline (``tracer.mark("mpc", ...)``), and in the SLO meter's
counters, so a soak report shows each promotion and why it survived or
died.

A copy of ``pivot_tpu/mpc/rollout.py`` (import paths rewritten); the
port's device policies forward ``apply_weights`` to their numpy twin.
"""

from __future__ import annotations

from typing import List, Optional

from pivot_tpu_torch.search.weights import PolicyWeights
from pivot_tpu_torch.utils import LogMixin

__all__ = ["WeightRollout"]

IDLE, CANARY, FLEET = "idle", "canary", "fleet"


class WeightRollout(LogMixin):
    """The promotion state machine.  Single-threaded by construction:
    every method is called from the controller loop only (the one
    thread that also runs the planner), so stage transitions need no
    lock of their own; driver interactions go through the driver's
    thread-safe surface (``policy_pool``, the SLO meter, the tracer).
    """

    def __init__(
        self,
        driver,
        *,
        tier: int = 0,
        canary_checks: int = 2,
        watch_checks: int = 2,
        regression_factor: float = 1.5,
        min_p99_s: float = 1e-4,
    ):
        if canary_checks < 1 or watch_checks < 1:
            raise ValueError("canary_checks/watch_checks must be >= 1")
        if regression_factor <= 1.0:
            raise ValueError(
                f"regression_factor must be > 1, got {regression_factor}"
            )
        self.driver = driver
        self.tier = int(tier)
        self.canary_checks = int(canary_checks)
        self.watch_checks = int(watch_checks)
        self.regression_factor = float(regression_factor)
        #: Floor on the regression reference: a canary started in an
        #: idle window (p99 ≈ 0) must not treat the first real latency
        #: sample as an infinite-ratio regression.
        self.min_p99_s = float(min_p99_s)
        self.stage = IDLE
        self.incumbent: Optional[PolicyWeights] = None
        self.events: List[dict] = []
        self.promotions = 0
        self.rollbacks = 0
        self._candidate: Optional[PolicyWeights] = None
        self._saved: List = []       # (label, policy, saved_weights)
        self._reference_p99 = 0.0
        self._checks = 0

    # -- observability ------------------------------------------------------
    def record(self, stage: str, detail: str = "", **extra) -> None:
        evt = {
            "wall_s": round(self.driver.slo.wall_clock, 4),
            "stage": stage,
            "detail": detail,
            **extra,
        }
        self.events.append(evt)
        self.driver.tracer.mark("mpc", stage, detail=detail, **extra)

    # -- stage transitions --------------------------------------------------
    def propose(self, weights: PolicyWeights, reference_p99: float) -> bool:
        """Shadow winner → canary: apply ``weights`` to one session.

        ``reference_p99`` is the governed tier's p99 over the windows
        *before* the rollout — the yardstick every later regression
        check compares against.  Returns False (and records why) when a
        rollout is already staging or the pool rejects the vector.
        """
        if self.stage != IDLE:
            return False
        pool = self.driver.policy_pool()
        if not pool:
            return False
        label, policy = pool[0]
        saved = policy.weights
        try:
            policy.apply_weights(weights)
        except ValueError as e:
            # A gated configuration (Pallas / sharded / realtime-bw)
            # rejects learned exponents — the rollout records and
            # drops the candidate instead of crashing the controller.
            self.record(IDLE, detail=f"canary rejected: {e}")
            return False
        self.stage = CANARY
        self._candidate = weights
        self._saved = [(label, policy, saved)]
        self._reference_p99 = max(float(reference_p99), self.min_p99_s)
        self._checks = 0
        self.driver.slo.count("mpc_canaries")
        self.record(
            CANARY, detail=f"canary on {label}",
            weights=[round(float(x), 4) for x in weights],
        )
        return True

    def check(self, p99: float) -> Optional[str]:
        """One decision window's verdict for the staging rollout.

        Returns the transition taken (``"promote"``, ``"rollback"``,
        ``"adopt"``) or None when nothing moved.  Called every
        controller window with the governed tier's windowed p99.
        """
        if self.stage == IDLE:
            return None
        if float(p99) > self.regression_factor * self._reference_p99:
            self._rollback(p99)
            return "rollback"
        self._checks += 1
        if self.stage == CANARY and self._checks >= self.canary_checks:
            return self._promote_fleet(p99)
        if self.stage == FLEET and self._checks >= self.watch_checks:
            self._adopt(p99)
            return "adopt"
        return None

    def _promote_fleet(self, p99: float) -> str:
        """Canary survived its windows: roll the vector to every pool
        policy (the canary's is already applied).  Any rejection mid-
        fleet rolls the whole attempt back — a split-brain pool scoring
        with two vectors is worse than either vector."""
        applied = {label for label, _, _ in self._saved}
        for label, policy in self.driver.policy_pool():
            if label in applied:
                continue
            try:
                saved = policy.weights
                policy.apply_weights(self._candidate)
                self._saved.append((label, policy, saved))
            except ValueError as e:
                self.record(FLEET, detail=f"fleet apply failed on {label}: {e}")
                self._rollback(p99)
                return "rollback"
        self.stage = FLEET
        self._checks = 0
        self.driver.slo.count("mpc_fleet_promotions")
        self.record(FLEET, detail=f"fleet of {len(self._saved)}")
        return "promote"

    def _adopt(self, p99: float) -> None:
        """Fleet watch clean: the candidate is the new incumbent."""
        self.promotions += 1
        self.incumbent = self._candidate
        self.record(
            IDLE, detail="adopted", p99_s=round(float(p99), 6),
        )
        self.stage = IDLE
        self._candidate = None
        self._saved = []

    def _rollback(self, p99: float) -> None:
        """SLO regression: restore every touched policy's saved vector
        (reverse order — the canary last, matching apply order)."""
        for label, policy, saved in reversed(self._saved):
            try:
                policy.apply_weights(saved)
            except ValueError:  # pragma: no cover - saved vectors re-apply
                self.log.warning("rollback re-apply failed on %s", label)
        self.rollbacks += 1
        self.driver.slo.count("mpc_rollbacks")
        self.record(
            IDLE,
            detail=f"rollback from {self.stage}",
            p99_s=round(float(p99), 6),
            reference_s=round(self._reference_p99, 6),
        )
        self.stage = IDLE
        self._candidate = None
        self._saved = []
