"""Multi-scene and multi-device paths of the port: seed sweeps
(``sweep.py``, the packed union in ``packed.py``), the device mesh
(``mesh.py``), and one scene split over a ring of shards (``ring.py``):
the dense bot-axis split (``spatial.py``) and the sharded table loop,
single-scene and dp x tp (``spatial_table.py``)."""
