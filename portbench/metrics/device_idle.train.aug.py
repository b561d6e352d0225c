"""``device_idle.train`` of the augmented cell: the same reading
(``metrics/device_idle.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("device_idle.train").read
