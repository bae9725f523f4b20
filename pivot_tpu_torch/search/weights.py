"""The searchable scoring-weight vector shared by every backend.

Until this round the scoring knobs lived as scattered constructor
arguments: ``risk_weight`` / ``rework_cost`` on every policy
(``sched/policies.py``, ``sched/tpu.py``, consumed by the kernels'
``risk`` operand via ``policies.resolve_risk``) and the fit / egress /
bandwidth coefficients hard-coded as implicit 1.0 exponents inside each
score expression (``cost_rt × decay / (norm × bw_rt)``).  The ensemble
estimator already exposed the exponent triple as ``score_params``
(``score_param_sweep``) — but nothing typed the full vector, so there
was nothing a search loop could optimize over.

:class:`PolicyWeights` is that vector.  Five dimensions:

  ==============  =====================================================
  ``w_cost``      exponent on the round-trip egress-cost term
  ``w_bw``        exponent on the round-trip bandwidth term
  ``w_norm``      exponent on the residual-capacity (fit) norm
  ``risk_weight`` weight of the eviction-risk penalty
                  (``risk_weight × hazard × rework_cost``, the round-11 risk rule)
  ``rework_cost`` scalar price of a lost placement (the risk term's
                  other factor)
  ==============  =====================================================

**Bit-parity contract**: the default vector is exactly today's
hand-tuned configuration — exponents ``(1, 1, 1)`` and a disengaged
risk term — and every backend that accepts ``weights=`` must route the
default through its existing unparameterized code path (the CPU
policies branch on :meth:`score_exponents` returning None; the device
wrappers reduce it to the ``risk=None`` operand), so constructing a
policy with ``weights=PolicyWeights()`` reproduces current decisions
bit for bit.  ``tests/test_search.py`` pins this.

The module is deliberately dependency-light (numpy only): it sits at
the bottom of the search subsystem and is imported by ``sched`` — the
one place the layering inverts, and it must never drag the optimizer
stack along.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PolicyWeights", "SearchSpace", "DEFAULT_WEIGHTS"]


class PolicyWeights(NamedTuple):
    """One point in scoring-weight space.  See the module docstring for
    dimension semantics and the bit-parity contract of the default."""

    w_cost: float = 1.0
    w_bw: float = 1.0
    w_norm: float = 1.0
    risk_weight: float = 0.0
    rework_cost: float = 1.0

    #: Dimensionality of the searchable vector (the optimizers' D).
    DIM = 5
    #: Field names in vector order (``to_array`` / ``from_array``).
    NAMES = ("w_cost", "w_bw", "w_norm", "risk_weight", "rework_cost")

    # -- vector codec ------------------------------------------------------
    def to_array(self) -> np.ndarray:
        """[5] float64 vector in :data:`NAMES` order."""
        return np.asarray(tuple(self), dtype=np.float64)

    @classmethod
    def from_array(cls, arr) -> "PolicyWeights":
        a = np.asarray(arr, dtype=np.float64).reshape(-1)
        if a.shape[0] != cls.DIM:
            raise ValueError(
                f"PolicyWeights vector must have {cls.DIM} entries "
                f"({', '.join(cls.NAMES)}), got shape {np.shape(arr)}"
            )
        if not np.all(np.isfinite(a)):
            raise ValueError(f"PolicyWeights entries must be finite, got {a}")
        return cls(*(float(x) for x in a))

    @classmethod
    def stack(cls, seq: Sequence["PolicyWeights"]) -> np.ndarray:
        """[B, 5] candidate matrix — the population shape the fitness
        evaluator consumes (``evaluate_candidates``)."""
        rows = [
            w.to_array() if isinstance(w, PolicyWeights)
            else cls.from_array(w).to_array()
            for w in seq
        ]
        if not rows:
            raise ValueError("cannot stack an empty PolicyWeights population")
        return np.stack(rows)

    # -- backend resolution ------------------------------------------------
    def score_exponents(self) -> Optional[Tuple[float, float, float]]:
        """``(w_cost, w_bw, w_norm)`` when any exponent departs from the
        reference shape, else None — the None return IS the bit-parity
        switch: backends keep their exact unparameterized score
        expression (no ``pow``) whenever it is None, exactly like
        ``resolve_risk`` returning None keeps the risk-free program."""
        exps = (self.w_cost, self.w_bw, self.w_norm)
        if exps == (1.0, 1.0, 1.0):
            return None
        return exps

    def risk_coefficient(self) -> float:
        """``risk_weight × rework_cost`` — the scalar the per-host hazard
        row is scaled by (the two knobs only ever enter as this product;
        keeping both dimensions lets the search freeze one — see
        :class:`SearchSpace`)."""
        return self.risk_weight * self.rework_cost

    def validate(self) -> "PolicyWeights":
        """Self with the invariants every backend assumes: finite entries
        and a non-negative risk term (a negative risk weight would turn
        hazard into a *reward* and break the lexicographic first-fit
        rule's tie semantics)."""
        arr = self.to_array()
        if not np.all(np.isfinite(arr)):
            raise ValueError(f"PolicyWeights entries must be finite: {self}")
        if self.risk_weight < 0 or self.rework_cost < 0:
            raise ValueError(
                "risk_weight and rework_cost must be >= 0 "
                f"(got {self.risk_weight}, {self.rework_cost})"
            )
        return self


#: The hand-tuned configuration every backend shipped with — the search
#: loops' parity anchor and the regret reports' "hand-tuned" arm.
DEFAULT_WEIGHTS = PolicyWeights()


class SearchSpace(NamedTuple):
    """Box-bounded search domain over :class:`PolicyWeights` vectors.

    ``lo`` / ``hi`` are [5] bounds in :data:`PolicyWeights.NAMES` order;
    ``frozen`` marks dimensions the optimizers must pin to their initial
    value (``rework_cost`` defaults frozen: it prices the environment's
    restart overhead, and since the risk penalty only consumes the
    product ``risk_weight × rework_cost`` the pair is not jointly
    identifiable — searching both just adds a flat direction).
    """

    lo: np.ndarray
    hi: np.ndarray
    frozen: np.ndarray  # [5] bool

    @classmethod
    def default(
        cls,
        exp_lo: float = 0.0,
        exp_hi: float = 3.0,
        risk_hi: float = 50.0,
        freeze_rework: bool = True,
    ) -> "SearchSpace":
        lo = np.array([exp_lo, exp_lo, exp_lo, 0.0, 1.0], dtype=np.float64)
        hi = np.array([exp_hi, exp_hi, exp_hi, risk_hi, 1.0], dtype=np.float64)
        frozen = np.array([False, False, False, False, freeze_rework])
        if not freeze_rework:
            hi[4] = risk_hi
        return cls(lo=lo, hi=hi, frozen=frozen)

    def clip(self, pop: np.ndarray, anchor: np.ndarray) -> np.ndarray:
        """Population [B, 5] clipped into the box, frozen dims reset to
        ``anchor``'s values.  Pure and deterministic — the optimizers'
        projection step."""
        out = np.clip(np.asarray(pop, dtype=np.float64), self.lo, self.hi)
        out[:, self.frozen] = np.asarray(anchor, dtype=np.float64)[self.frozen]
        return out
