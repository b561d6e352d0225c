"""``validate_share.train`` of the ZINB configuration's cells, which move
``train_cells_per_s.zinb``: the same reading (``metrics/validate_share.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("validate_share.train").read
