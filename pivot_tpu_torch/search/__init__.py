"""Policy scoring weights.

Port of ``pivot_tpu/search/__init__.py``, cut to :mod:`weights`: the
scheduler imports :class:`PolicyWeights` from here.  The optimizers, the
fitness evaluator and the oracle are not ported yet.
"""

from pivot_tpu_torch.search.weights import (  # noqa: F401
    DEFAULT_WEIGHTS,
    PolicyWeights,
    SearchSpace,
)

__all__ = ["DEFAULT_WEIGHTS", "PolicyWeights", "SearchSpace"]
