"""``idle_in_step.train`` of the augmented cell: the same reading
(``metrics/idle_in_step.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("idle_in_step.train").read
