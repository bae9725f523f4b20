"""Replica-parallel estimators of the port (``pivot_tpu/parallel``).

``ensemble``: the Monte-Carlo ensemble rollout, batched over a leading
replica axis on one device.  ``mesh``: the device meshes of
``pivot_tpu/parallel/mesh.py`` (a named grid of torch devices; S logical
host shards on one card), which ``ops/shard.py``'s host-sharded passes
and ``enable_sharding`` read.  The sharded rollout is not ported yet
(ROADMAP.md Queue 1 item 9d).
"""
