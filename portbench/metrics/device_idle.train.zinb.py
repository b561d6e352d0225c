"""``device_idle.train`` of the ZINB configuration's cells, which move
``train_cells_per_s.zinb``: the same reading (``metrics/device_idle.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("device_idle.train").read
