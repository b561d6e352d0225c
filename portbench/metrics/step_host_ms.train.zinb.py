"""``step_host_ms.train`` of the ZINB configuration's cells, which move
``train_cells_per_s.zinb``: the same reading (``metrics/step_host_ms.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("step_host_ms.train").read
