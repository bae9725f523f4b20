"""pivot_tpu_torch — the PyTorch/CUDA port of ``pivot_tpu``.

The same cost-aware DAG-scheduling simulator, with the device layer
written in PyTorch and the greedy-placement kernel written by hand in
CUDA C++ for Hopper (``csrc/greedy_place.cu``).  The package mirrors the
layout of ``pivot_tpu`` and keeps its own copy of every module it needs:
it imports ``torch`` and numpy, never ``jax`` and never ``pivot_tpu``.

  - ``des``, ``workload``, ``infra``, ``obs``, ``utils``, ``search``:
    copies of the JAX-free reference layers;
  - ``sched``: the scheduler runtime, the numpy policies, and the device
    policies of ``sched/cuda.py``;
  - ``ops``: the placement kernels as plain torch (``ops/kernels.py``)
    and the hand-written CUDA kernel's wrapper (``ops/cuda_kernels.py``);
  - ``parallel``: the Monte-Carlo ensemble (faults, congestion,
    checkpoints, the sweeps);
  - ``serve``, ``mpc``, ``recover``: the online serving layer, its
    model-predictive controller and its crash-safe recovery plane;
  - ``experiments``: the runner, the CLI (``overall`` through ``search``
    and ``calibrate``), the calibration harness and the trace sampler.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
