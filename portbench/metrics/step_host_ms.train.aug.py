"""``step_host_ms.train`` of the augmented cell: the same reading
(``metrics/step_host_ms.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("step_host_ms.train").read
