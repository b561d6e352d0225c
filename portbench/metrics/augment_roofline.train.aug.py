"""Roofline share (%) of the frozen augmenter's forward in training: the
bound of its products over the device time of the kernels launched inside
the program's ``dvae.step.augment`` spans of the profiled slice.

The work of one step (``work``; a layer's product is a call, its input,
weights and output each counted once): fc1–fc4 on the batch's B rows (the
trunk does not depend on the arm), the noise layer, fc5, fc_mu, fc_sigma
and fc6–fc11 on the A·B per-arm rows.  At the configuration's peak
(``core/roofline.py``: f32 counts against TF32's 495 TFLOP/s), so f32
products on the FP32 cores read at most 67/495 ≈ 13.5%.  A kernel is
attributed to the span that held the host when it was launched (the
trace's correlation ids).  None without the span (a program that does
not mark it), a device trace or the slice's calls.
"""

from bisect import bisect_right

from portbench.core import roofline, spans
from portbench.core.trace import LAUNCH_CATEGORIES, merge

PHASE = "train"
SPAN = "step.augment"


def layers(m: dict) -> list:
    """[(layer, fan_in, fan_out, on every arm, has a bias)] of the
    augmenter group of a configuration's ``model``."""
    a = m["augmenter"]
    D, H, Z, NZ = a["input_dim"], a["n_dim"], a["latent_dim"], a["noise_dim"]
    D5, H5 = D // 5, H // 5
    trunk = [("fc1", D, D5), ("fc2", D5, D5), ("fc3", D5, H), ("fc4", H, H)]
    arms = [("noise", NZ, NZ), ("fc5", H + NZ, H5), ("fc_mu", H5, Z),
            ("fc_sigma", H5, Z), ("fc6", Z, H5), ("fc7", H5, H),
            ("fc8", H, H), ("fc9", H, D5), ("fc10", D5, D5), ("fc11", D5, D)]
    return ([(n, i, o, False, True) for n, i, o in trunk]
            + [(n, i, o, True, n != "noise") for n, i, o in arms])


def work(m: dict, rows: int, nbytes: int) -> list:
    """[(operations, bytes)] of the augmenter's forward on a batch of
    ``rows``: a call a layer."""
    out = []
    for _, i, o, per_arm, bias in layers(m):
        r = rows * (m["n_arm"] if per_arm else 1)
        out.append((2.0 * r * i * o,
                    (r * i + i * o + (o if bias else 0) + r * o) * nbytes))
    return out


def forward_flops(m: dict, rows: int) -> float:
    return sum(f for f, _ in work(m, rows, 4))


def launched_in(sl, name: str, cats=("kernel",)) -> list:
    """The device events of ``cats`` whose launch on the host lies inside
    a span ``dvae.<name>`` of the slice."""
    ivs = merge(spans.intervals(sl, name))
    if not ivs:
        return []
    starts = [s for s, _ in ivs]
    launch = {}
    for e in sl.events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
    out = []
    for e in sl.events:
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        at = launch.get((e.get("args") or {}).get("correlation"))
        if at is None:
            continue
        i = bisect_right(starts, at) - 1
        if i >= 0 and at <= ivs[i][1]:
            out.append(e)
    return out


def device_s(sl, name: str) -> float:
    """Device seconds of the kernels launched inside ``dvae.<name>``."""
    return sum(float(e.get("dur", 0.0)) for e in launched_in(sl, name)) / 1e6


def read(r):
    sl = spans.device_slice(r)
    calls = r.calls.get(PHASE)
    if sl is None or not calls:
        return None
    nbytes = roofline.DTYPE_BYTES[r.dtype]
    bound = sum(roofline.bound_s(work(r.model, rows, nbytes), r.dtype)
                for rows in calls)
    return roofline.share_pct(bound, device_s(sl, SPAN))
