"""``launches_per_step.train`` of the ZINB configuration's cells, which move
``train_cells_per_s.zinb``: the same reading (``metrics/launches_per_step.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("launches_per_step.train").read
