"""The frozen VAE-GAN augmenter of MMIDAS, and the MSE mixVAE step on the
per-arm views it makes, in plain PyTorch from their equations.

Source: the MMIDAS reference (github.com/AllenInstitute/MMIDAS),
mmidas/augmentation/udagan.py ``Augmenter_smartseq`` :217-329, as the
trainer uses it: loaded and put in eval mode once
(mmidas/cpl_mixvae.py:128-149, ``mk_augmenter``), then called on every
step with the noise scale 0.1, each arm taking its own view of the batch
(:422-425).  In eval mode dropout is the identity and every batch norm
reads its running statistics.  On the batch x (B, D) broadcast to the
arms, (A, B, D):

  trunk    h = relu(BN(fc1 x)); fc2 (D/5 → D/5); fc3 (→ H); fc4 (H → H)
  noise    n = elu(BNz(W (scale · z))), z ~ N(0, 1) (A, B, NZ), W
           without bias
  fc5      h = relu(BN(fc5 [h, n]))              (H + NZ → H/5)
  latent   μ = BN(fc_mu h), σ = sigmoid(fc_sigma h), s = μ + e·σ,
           e ~ N(0, 1) (A, B, Z)
  decoder  fc6 (Z → H/5), fc7 (→ H), fc8, fc9 (→ D/5), fc10, each
           relu(BN(·))
  view     relu(fc11 h)                          (D/5 → D)

A batch norm is (h − mean)/sqrt(var + eps) on its running statistics,
eps 1e-10 and no affine parameters; BNz is torch's default BatchNorm1d,
eps 1e-5 with its scale and bias.  A layer is h·W + b with W (fan_in,
fan_out).  The trunk runs on all A copies of the batch, as the source's
arm-major forward does, so a program that runs it once and broadcasts is
held to the copies.  Everything computes in its inputs' dtype: the
benchmark's comparison runs it in float64
(``traffic/train_resident_aug.follow``), the control in float32.  f32
products are true f32: ``precision("highest")``
(``portbench/reference/model.py``) sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False around them; the control
asks for ``"tf32"``.

The step on the views is the cpl-mixVAE loss of
``portbench/reference/model.py`` with arm a's input and reconstruction
target both its view v_a.

Departures from the source, each as the configuration states it:
  * weights are random, ``nn.Linear``'s default U(±1/sqrt(fan_in)), from
    the run's seed (``make_params``), and each batch norm's running
    statistics are those of its input over the training cells
    (``calibrate``), what a trained augmenter's converge to; BNz's scale
    and bias are torch's initial 1 and 0;
  * z and e come from the program's runner's generator
    (``draws_aug.AugRunnerDraws``); the source draws them from torch's
    global generator;
  * the ZINB head (fc11_p, n_zim > 1) is left out: the configuration has
    n_zim 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.model import (MISMATCH_THR, forward, leaf_names,
                                       matmul, precision)

BN_EPS = 1e-10          # every fc batch norm (udagan.py)
BNZ_EPS = 1e-5          # BNz, torch's default
TRUNK = (("fc1", "bn1"), ("fc2", "bn2"), ("fc3", "bn3"), ("fc4", "bn4"))
DECODER = (("fc6", "bn6"), ("fc7", "bn7"), ("fc8", "bn8"), ("fc9", "bn9"),
           ("fc10", "bn10"))


def layer_shapes(a: dict) -> dict:
    """{layer: (fan_in, fan_out)} of the augmenter group ``a`` of a
    configuration (udagan.py:217-250)."""
    D, H, Z, NZ = a["input_dim"], a["n_dim"], a["latent_dim"], a["noise_dim"]
    D5, H5 = D // 5, H // 5
    return {"noise": (NZ, NZ), "fc1": (D, D5), "fc2": (D5, D5),
            "fc3": (D5, H), "fc4": (H, H), "fc5": (H + NZ, H5),
            "fc_mu": (H5, Z), "fc_sigma": (H5, Z), "fc6": (Z, H5),
            "fc7": (H5, H), "fc8": (H, H), "fc9": (H, D5), "fc10": (D5, D5),
            "fc11": (D5, D)}


def make_params(a: dict, seed: int, device) -> dict:
    """Weights and biases, U(±1/sqrt(fan_in)), drawn on ``device`` with one
    ``torch.Generator`` in one call; the ``noise`` layer's bias is None."""
    shapes = sorted(layer_shapes(a).items())
    total = sum(i * o + (0 if n == "noise" else o) for n, (i, o) in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    u = torch.rand(total, generator=gen, device=device)
    params, at = {}, 0
    for name, (fan_in, fan_out) in shapes:
        bound = 1.0 / fan_in ** 0.5
        layer = {"b": None}
        for leaf, shape in (("w", (fan_in, fan_out)), ("b", (fan_out,))):
            if leaf == "b" and name == "noise":
                continue
            n = torch.Size(shape).numel()
            layer[leaf] = ((2.0 * u[at:at + n] - 1.0) * bound).reshape(shape)
            at += n
        params[name] = layer
    return params


def linear(p: dict, h: torch.Tensor) -> torch.Tensor:
    y = matmul(h, p["w"])
    return y if p["b"] is None else y + p["b"]


def batch_norm(h: torch.Tensor, stats, eps: float = BN_EPS) -> torch.Tensor:
    """Running statistics ``stats`` (eval), or the batch's own over every
    leading axis where ``stats`` is None; BNz's affine parameters where
    the statistics hold them."""
    if stats is None:
        red = tuple(range(h.dim() - 1))
        mean, var = h.mean(dim=red), h.var(dim=red, unbiased=False)
        stats = {}
    else:
        mean, var = stats["mean"], stats["var"]
    y = (h - mean) / torch.sqrt(var + eps)
    if "scale" in stats:
        y = y * stats["scale"] + stats["bias"]
    return y


def trunk(params: dict, bn: dict, x: torch.Tensor, n_arm: int,
          running: bool = True) -> torch.Tensor:
    """fc1–fc4 on x (B, D) broadcast to (A, B, D).  ``running`` False
    normalises with each arm's batch statistics instead (a fault the
    check must catch)."""
    h = x.expand(n_arm, *x.shape)
    for fc, norm in TRUNK:
        h = torch.relu(batch_norm(linear(params[fc], h),
                                  bn[norm] if running else None))
    return h


def head(params: dict, bn: dict, h: torch.Tensor, z: torch.Tensor,
         e: torch.Tensor, scale: float) -> torch.Tensor:
    """The noise path, fc5, the latent and the decoder on the trunk's
    (A, B, H): the (A, B, D) views."""
    n = F.elu(batch_norm(linear(params["noise"], scale * z), bn["bnz"],
                         BNZ_EPS))
    h = torch.relu(batch_norm(linear(params["fc5"], torch.cat([h, n], -1)),
                              bn["bn5"]))
    mu = batch_norm(linear(params["fc_mu"], h), bn["bn_mu"])
    sigma = torch.sigmoid(linear(params["fc_sigma"], h))
    h = mu + e * sigma
    for fc, norm in DECODER:
        h = torch.relu(batch_norm(linear(params[fc], h), bn[norm]))
    return torch.relu(linear(params["fc11"], h))


@torch.no_grad()
def views(params: dict, bn: dict, x: torch.Tensor, n_arm: int,
          z: torch.Tensor, e: torch.Tensor, scale: float,
          mode: str = "highest", running: bool = True) -> torch.Tensor:
    """The (A, B, D) views of x (B, D), products in ``mode``."""
    with precision(mode):
        return head(params, bn, trunk(params, bn, x, n_arm, running), z, e,
                    scale)


@torch.no_grad()
def calibrate(params: dict, x: torch.Tensor, a: dict, scale: float,
              seed: int) -> dict:
    """Running statistics of every batch norm: the mean and (biased)
    variance of its input over the rows of x (N, D), layer by layer, each
    layer's input normalised by the statistics set before it; z and e
    drawn once a row from ``seed``.  BNz gets its initial scale 1 and
    bias 0."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    n = x.shape[0]
    bn = {}

    def norm(name, y, eps=BN_EPS, extra=None):
        bn[name] = {"mean": y.mean(dim=0),
                    "var": y.var(dim=0, unbiased=False), **(extra or {})}
        return batch_norm(y, bn[name], eps)

    with precision("highest"):
        h = x
        for fc, name in TRUNK:
            h = torch.relu(norm(name, linear(params[fc], h)))
        z = torch.randn((n, a["noise_dim"]), generator=gen, device=x.device)
        NZ = a["noise_dim"]
        affine = {"scale": torch.ones(NZ, device=x.device),
                  "bias": torch.zeros(NZ, device=x.device)}
        nz = F.elu(norm("bnz", linear(params["noise"], scale * z), BNZ_EPS,
                        affine))
        h = torch.relu(norm("bn5", linear(params["fc5"],
                                          torch.cat([h, nz], -1))))
        mu = norm("bn_mu", linear(params["fc_mu"], h))
        e = torch.randn(mu.shape, generator=gen, device=x.device)
        h = mu + e * torch.sigmoid(linear(params["fc_sigma"], h))
        for fc, name in DECODER:
            h = torch.relu(norm(name, linear(params[fc], h)))
    return bn


# ---------------------------------------------------------------------------
# The mixVAE step on per-arm views
# ---------------------------------------------------------------------------

def recon_mse_views(x_rec: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``model.recon_mse`` with arm a's target its view v_a (A, B, D)."""
    _, B, D = v.shape
    sumsq = ((x_rec - v) ** 2).sum(dim=(1, 2))
    mism = ((x_rec > MISMATCH_THR) != (v > MISMATCH_THR)).sum(dim=(1, 2))
    return 0.5 * sumsq / B + (50.0 * mism / (B * D)).to(sumsq.dtype)


def loss_views(out: dict, v: torch.Tensor, m: dict) -> dict:
    """``model.loss`` (MSE mode, no prior) with the reconstruction term of
    arm a against its own view v_a; every other term as there:

      total = (A−1)·Σ_a (rec_a + β·KL_a) + λ·Σ_{a<b} d(a, b)
            + (A−1)·Σ_a Σ_c c log c + pairs·(C/2·log 2π − ½·log 2λ)"""
    if m["mode"] != "MSE":
        raise ValueError("the augmented step is written for MSE mode")
    A, C, eps = m["n_arm"], m["n_categories"], m["eps"]
    rec = recon_mse_views(out["x_rec"], v)
    mu, lv = out["s_mean"], out["s_logvar"]
    kl = (-0.5 * (1 + lv - mu ** 2 - torch.exp(lv)).mean(dim=1)).sum(dim=-1)
    c = out["c"]
    logc = torch.log(c + eps)
    negent = (c * logc).sum(dim=-1).mean(dim=-1)
    inv_sd = torch.sqrt(1.0 / (torch.var(c, dim=1, keepdim=True) + eps))
    scaled = logc * inv_sd
    dist = c.new_zeros(())
    for a in range(A):
        for b in range(a + 1, A):
            dist = dist + ((scaled[a] - scaled[b]) ** 2).sum(dim=-1).mean()
    pairs = max(A * (A - 1) // 2, 1)
    const = pairs * ((C / 2) * math.log(2 * math.pi)
                     - 0.5 * math.log(2 * m["lam"]))
    scaler = max(A - 1, 1)
    total = (scaler * (rec + m["beta"] * kl).sum() + m["lam"] * dist
             + scaler * negent.sum() + const)
    return {"total": total, "rec": rec, "kl": kl}


def value_and_grads(params: dict, v: torch.Tensor, m: dict, noise: dict):
    """(total loss, {(layer, leaf): gradient}) of one training step on the
    views v (A, B, D): ``model.forward`` takes them as its per-arm input."""
    names = leaf_names(params)
    live = {n: {k: params[n][k].detach().requires_grad_() for k in params[n]}
            for n in params}
    with torch.enable_grad():
        total = loss_views(forward(live, v, m, True, noise), v, m)["total"]
        grads = torch.autograd.grad(total, [live[n][k] for n, k in names],
                                    allow_unused=True)
    return total.detach(), {nk: (torch.zeros_like(params[nk[0]][nk[1]])
                                 if g is None else g)
                            for nk, g in zip(names, grads)}
