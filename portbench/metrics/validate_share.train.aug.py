"""``validate_share.train`` of the augmented cell: the same reading
(``metrics/validate_share.train.py``)."""

from portbench.core import spec

read = spec.metric_reader("validate_share.train").read
