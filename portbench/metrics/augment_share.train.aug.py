"""Share (%) of the device time of the kernels launched inside the
program's ``dvae.step`` spans of the profiled training slice that was
launched inside ``dvae.step.augment``: the frozen augmenter's part of the
step.  None without either span or a device trace."""

from portbench.core import spans, spec

AUG = spec.metric_reader("augment_roofline.train.aug")


def read(r):
    sl = spans.device_slice(r)
    if sl is None:
        return None
    step = AUG.device_s(sl, "step")
    aug = AUG.device_s(sl, AUG.SPAN)
    if step <= 0 or aug <= 0:
        return None
    return 100.0 * aug / step
