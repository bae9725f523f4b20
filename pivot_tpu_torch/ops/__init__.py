"""Placement kernels: plain torch forms and the hand-written CUDA kernel.

Port of ``pivot_tpu/ops/``: ``kernels.py`` holds the torch forms of the
scan oracles and the two-phase kernels; ``cuda_kernels.py`` wraps the
hand-written Hopper kernel that replaces the Pallas greedy pass; and
``build.py`` compiles the CUDA sources at first use.
"""
