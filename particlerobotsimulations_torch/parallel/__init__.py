"""Multi-shard paths of the port: the sharded table loop over a ring of
shards (``spatial_table.py``, ``ring.py``)."""
