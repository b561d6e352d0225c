"""``train_mfu`` of the ZINB configuration's cells, which move
``train_cells_per_s.zinb``: the same reading (``metrics/train_mfu.py``)."""

from portbench.core import spec

read = spec.metric_reader("train_mfu").read
