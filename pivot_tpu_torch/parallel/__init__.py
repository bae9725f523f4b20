"""Replica-parallel estimators of the port (``pivot_tpu/parallel``).

``ensemble``: the Monte-Carlo ensemble rollout, batched over a leading
replica axis on one device, and its replica-sharded forms
(``sharded_rollout``, ``shard_sweep``).  ``mesh``: the device meshes of
``pivot_tpu/parallel/mesh.py`` (a named grid of torch devices; S logical
shards on one card), which ``ops/shard.py``'s host-sharded passes,
``enable_sharding``, the sharded ensemble and search, and the dispatch
batcher's replica mesh read.
"""
