"""The numbers that decide ``correct``: the program's outputs against the
plain reference's.

Training (three steps through the runner, from the same weights, rows and
noise): each step's loss (``loss1`` the first step's, ``loss`` the worst
of the three); the first gradient as the optimizer got it; the
parameters' change over the three steps.  Norms are compared leaf by leaf
by the gap between the two norms (not the norm of the difference),
against the reference's norm of that leaf or of the median leaf,
whichever is larger; the number is the worst leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's (the biases
in front of a batch norm, whose true gradient is nought) move by round-off
alone and are left out of the change.  ``grad_diff`` is the norm of the
difference, leaf by leaf, on the same scale.

Serving (requests sampled from the seed, each compared whole): the
largest error of each returned field against the largest reference
value; the labels that are not the argmax of their served posterior; the
widest gap by which a served label's sharpened logit lies below the
reference's best; the losses; the consensus against the one the served
labels give; the category mask.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TINY_GRAD = 1e-3    # leaves under this share of the median leaf's gradient


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def _scale(norms: dict, keys) -> dict:
    med = float(np.median([norms[k] for k in keys])) if keys else 0.0
    return {k: max(norms[k], med) for k in keys}


def norm_gaps(prog: dict, ref: dict, keys=None) -> dict:
    """{leaf: |‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf's ‖ref‖)}."""
    keys = sorted(ref) if keys is None else keys
    pn = _norms({k: prog[k] for k in keys})
    rn = _norms({k: ref[k] for k in keys})
    sc = _scale(rn, keys)
    return {k: abs(pn[k] - rn[k]) / sc[k] if sc[k] > 0 else
            (0.0 if pn[k] == 0 else math.inf) for k in keys}


def diff_norms(prog: dict, ref: dict, keys=None) -> dict:
    """{leaf: ‖prog − ref‖ / max(‖ref‖, median leaf's ‖ref‖)}."""
    keys = sorted(ref) if keys is None else keys
    rn = _norms({k: ref[k] for k in keys})
    sc = _scale(rn, keys)
    return {k: float(torch.linalg.vector_norm(
        (prog[k].double() - ref[k].double()))) / sc[k]
        if sc[k] > 0 else math.inf for k in keys}


def moving_leaves(ref_grad: dict) -> list:
    """Leaves whose reference gradient is at least TINY_GRAD of the median
    leaf's."""
    rn = _norms(ref_grad)
    med = float(np.median(list(rn.values())))
    return sorted(k for k, v in rn.items() if v >= TINY_GRAD * med)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (3 floats), ``grad``
    ({leaf: first gradient}) and ``change`` ({leaf: parameters after three
    steps minus before})."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    grad = norm_gaps(prog["grad"], ref["grad"])
    diff = diff_norms(prog["grad"], ref["grad"])
    keep = moving_leaves(ref["grad"])
    change = norm_gaps(prog["change"], ref["change"], keep)
    return {"loss": max(gaps), "loss1": gaps[0],
            "grad": max(grad.values()),
            "grad_diff": max(diff.values()),
            "grad_diff_median": float(np.median(list(diff.values()))),
            "change": max(change.values()),
            "worst_grad_leaf": max(grad, key=grad.get),
            "worst_change_leaf": max(change, key=change.get),
            "left_out": sorted(set(ref["grad"]) - set(keep))}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def consensus(labels: np.ndarray, K: int) -> float:
    """Mean over arm pairs of the mean normalised diagonal of their
    confusion matrix, column j divided by max(row j sum, column j sum)
    (mmidas/_utils.py:83-93, cpl_mixvae.py's consensus)."""
    A = labels.shape[0]
    scores = []
    for a in range(A):
        for b in range(a + 1, A):
            cm = np.bincount(labels[a].astype(np.int64) * K
                             + labels[b].astype(np.int64),
                             minlength=K * K).reshape(K, K).astype(np.float64)
            mx = np.maximum(cm.sum(axis=0), cm.sum(axis=1))
            diag = np.divide(np.diag(cm), mx, out=np.zeros(K), where=mx != 0)
            scores.append(diag.mean())
    return float(np.mean(scores)) if scores else 1.0


class ServeErrors:
    """Running maxima over the sampled requests."""

    FIELDS = (("c_prob", "c"), ("state_mu", "s_mean"),
              ("state_logvar", "s_logvar"), ("x_low", "x_low"))
    # fields computed from the categorical sample, compared where the
    # served label is the reference's (a flip at a near tie moves them by
    # a column of fc_mu; ``label_gap`` judges the flip itself)
    AFTER_LABEL = ("state_mu", "state_logvar")

    def __init__(self):
        self.err = {k: 0.0 for k, _ in self.FIELDS}
        self.scale = {k: 0.0 for k, _ in self.FIELDS}
        self.n = {"label_gap": 0.0, "labels": 0.0, "loss_rec": 0.0,
                  "total_loss": 0.0, "consensus": 0.0, "mask": 0.0}
        self.requests = 0

    def add(self, served: dict, ref: dict, m: dict) -> None:
        """One request: ``served`` as ``eval_model`` returned it, ``ref``
        as ``reference.model.evaluate`` did (tensors)."""
        self.requests += 1
        lab = np.asarray(served["pred_label"])
        cp = ref["c_prob"].double().cpu().numpy()       # (A, n, C)
        same = (lab == ref["lab"].cpu().numpy()) if lab.shape == cp.shape[:2] \
            else None
        for key, rkey in self.FIELDS:
            r = ref[rkey].double().cpu().numpy()
            p = np.asarray(served[key], np.float64)
            if p.shape != r.shape or not np.isfinite(p).all():
                self.err[key] = math.inf
                continue
            d = np.abs(p - r)
            if key in self.AFTER_LABEL:
                if same is None:
                    self.err[key] = math.inf
                    continue
                d = d[same]
            self.err[key] = max(self.err[key], float(d.max(initial=0.0)))
            self.scale[key] = max(self.scale[key], float(np.abs(r).max()))
        if lab.shape != cp.shape[:2]:
            self.n["label_gap"] = self.n["labels"] = math.inf
        else:
            best = cp.max(axis=-1)
            got = np.take_along_axis(cp, lab[..., None].astype(np.int64),
                                     axis=-1)[..., 0]
            self.n["label_gap"] = max(self.n["label_gap"],
                                      float((best - got).max()) / m["tau"])
            # a label is the argmax of its served posterior, which is
            # itself held to the reference's (``c_prob``)
            c = np.asarray(served["c_prob"])
            at = np.take_along_axis(c, lab[..., None].astype(np.int64),
                                    axis=-1)[..., 0]
            self.n["labels"] += float(np.sum(at < c.max(axis=-1)))
        r = ref["total_loss_rec"].cpu().numpy()
        p = np.asarray(served["total_loss_rec"], np.float64)
        self.n["loss_rec"] = max(self.n["loss_rec"],
                                 float(np.max(np.abs(p - r) / np.abs(r))))
        self.n["total_loss"] = max(
            self.n["total_loss"], abs(float(served["total_loss"])
                                      - ref["total_loss"])
            / abs(ref["total_loss"]))
        if lab.shape == cp.shape[:2]:
            self.n["consensus"] = max(self.n["consensus"], abs(
                float(served["consensus"])
                - consensus(lab, m["n_categories"])))
        self.n["mask"] = max(self.n["mask"], float(np.sum(
            np.asarray(served["mask"]) != 1.0)))

    def numbers(self) -> dict:
        out = {k: (self.err[k] / self.scale[k] if self.scale[k] > 0
                   else self.err[k]) for k, _ in self.FIELDS}
        out.update(self.n)
        return {k: (v if math.isfinite(v) else math.inf)
                for k, v in out.items()}


# ---------------------------------------------------------------------------
# Judging
# ---------------------------------------------------------------------------

def judge(numbers: dict, limits: dict):
    """(correct, checks): every number that has a limit is at most it (a
    NaN or infinity is over any limit); ``checks`` maps each to its value
    and limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        v = float(v)
        good = math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
