"""``launches_per_step.train`` of the augmented cell, the augmenter's
launches included: the same reading
(``metrics/launches_per_step.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("launches_per_step.train").read
