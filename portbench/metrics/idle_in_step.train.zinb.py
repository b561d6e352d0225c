"""``idle_in_step.train`` of the ZINB configuration's cells, which move
``train_cells_per_s.zinb``: the same reading (``metrics/idle_in_step.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("idle_in_step.train").read
