"""Multi-scene and multi-shard paths of the port: seed sweeps
(``sweep.py``, the packed union in ``packed.py``) and the sharded table
loop over a ring of shards (``spatial_table.py``, ``ring.py``)."""
