"""Parallel serving paths over a list of devices (``mesh.py``): sequence
parallelism for the BigCodec (``sp.py``), tensor and pipeline parallelism
for the Conformer (``tp.py``, ``pp.py``)."""
