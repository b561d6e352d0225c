"""``encoder_roofline.train`` of the ZINB configuration's cells, which move
``train_cells_per_s.zinb``: the same reading (``metrics/encoder_roofline.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("encoder_roofline.train").read
