"""Device events (kernels, copies, memsets) a training step in the
profiled slice: one chunk of the runner, its host read and its
validation, over the chunk's steps.  An exact count."""


def read(r):
    steps = r.host.get("slice_train_steps", 0)
    if r.slice is None or steps <= 0 or not r.slice.device:
        return None
    return len(r.slice.device) / steps
