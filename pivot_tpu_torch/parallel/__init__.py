"""Replica-parallel estimators of the port (``pivot_tpu/parallel``).

``ensemble``: the Monte-Carlo ensemble rollout, batched over a leading
replica axis on one device.  The mesh helpers of ``pivot_tpu/parallel/
mesh.py`` and the sharded rollout are not ported yet (ROADMAP.md).
"""
