"""The coupled mixture VAE of MMIDAS in plain PyTorch, from its equations.

Source: the MMIDAS reference (github.com/AllenInstitute/MMIDAS,
mmidas/nn_model.py: ``mixVAE_model`` :89-493, its ``loss`` :495-598 and
``zinb_loss`` :642-676).  A arms, each an encoder D → F → F → F → F → L
(ReLU, then batch norm without affine parameters after every layer), a
categorical head L → C (softmax, sharpened by 1/τ), a state head
(L + C) → S (mean and sigmoid variance), and a decoder (C + S) → L → F → F
→ F → F → D.  Parameters are per arm, stacked on a leading A axis:
weights (A, fan_in, fan_out), biases (A, fan_out), a layer is x·W + b.

Everything here is float32.  ``matmul`` is the one place a product is
taken, so that the precision of products is set in one place:
``"highest"`` (true f32: TF32 off, the reference) or ``"tf32"`` (the
control: TF32 on the card, operands rounded to TF32 on the CPU).

Departures from the reference source, each as the program has it:
  * the reparameterisation noise is Gaussian (the source draws uniform
    noise at :427, a flag of the program that the configurations leave
    off);
  * batch norm's epsilon is the model's ``eps`` (1e-8), not torch's 1e-5.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

ENCODER = ("fc1", "fc2", "fc3", "fc4", "fc5")
DECODER = ("fc7", "fc8", "fc9", "fc10")
MISMATCH_THR = 0.1      # binarize() threshold of the MSE loss's BCE term
ZINB_EPS = 1e-6         # zinb_loss's eps
ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}


def layer_shapes(m: dict) -> dict:
    """{layer: (fan_in, fan_out)} of one arm."""
    D, Fd, L, C, S = (m["input_dim"], m["fc_dim"], m["lowD_dim"],
                      m["n_categories"], m["state_dim"])
    shapes = {"fc1": (D, Fd), "fc2": (Fd, Fd), "fc3": (Fd, Fd),
              "fc4": (Fd, Fd), "fc5": (Fd, L), "fcc": (L, C),
              "fc_mu": (L + C, S), "fc_sigma": (L + C, S), "fc6": (C + S, L),
              "fc7": (L, Fd), "fc8": (Fd, Fd), "fc9": (Fd, Fd),
              "fc10": (Fd, Fd), "fc11": (Fd, D)}
    if m["mode"] == "ZINB":
        shapes["fc11_p"] = (Fd, D)
        shapes["fc11_r"] = (Fd, D)
    return shapes


def leaf_names(params: dict) -> list:
    """(layer, leaf) pairs in sorted order."""
    return [(n, k) for n in sorted(params) for k in sorted(params[n])]


# ---------------------------------------------------------------------------
# Products and their precision
# ---------------------------------------------------------------------------

def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero, as the card converts operands; the gradient
    passes straight through the rounding."""
    bits = t.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return t + (bits.view(torch.float32) - t).detach()


@contextlib.contextmanager
def precision(mode: str):
    """Products inside run in ``mode``: ``"highest"`` or ``"tf32"``."""
    if mode not in ("highest", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if (a.device.type == "cpu" and torch.backends.cuda.matmul.allow_tf32):
        # the CPU has no TF32 products: round the operands as the card does
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


def linear(p: dict, h: torch.Tensor) -> torch.Tensor:
    """(A, B, in) or (B, in) · (A, in, out) + (A, out) → (A, B, out)."""
    return matmul(h, p["w"]) + p["b"][:, None, :]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def batch_norm(h: torch.Tensor, eps: float, stats=None) -> torch.Tensor:
    """Batch norm over the rows of each arm without affine parameters:
    batch statistics (biased variance) in training, the running ``stats``
    (mean, var) in eval."""
    if stats is None:
        mean = h.mean(dim=1, keepdim=True)
        var = ((h - mean) ** 2).mean(dim=1, keepdim=True)
    else:
        mean, var = stats["mean"][:, None, :], stats["var"][:, None, :]
    return (h - mean) / torch.sqrt(var + eps)


def forward(params: dict, x: torch.Tensor, m: dict, train: bool,
            noise: dict, bn=None) -> dict:
    """The A arms' forward on x (B, D).

    Training (``train``): ``noise`` holds ``x_keep`` (A, B, D) bool, input
    dropout's keep-mask; ``u`` (A, B, C) the Gumbel uniforms; ``e`` (A, B,
    S) the reparameterisation noise; ``s_keep`` (A, B, S) state dropout's
    keep-mask.  Eval: ``e`` only, the categorical sample is the one-hot of
    the posterior's argmax, and ``bn`` holds the running statistics."""
    eps, A = m["eps"], m["n_arm"]
    if train:
        keep = 1.0 - m["x_drop"]
        h = torch.where(noise["x_keep"], x / keep,
                        torch.zeros((), device=x.device))
    else:
        h = x
    for name in ENCODER:
        h = batch_norm(torch.relu(linear(params[name], h)), eps,
                       None if train else bn[name.replace("fc", "bn")])
    x_low = h
    c_prob = torch.softmax(linear(params["fcc"], x_low), dim=-1)
    c = torch.softmax(c_prob / m["tau"], dim=-1)
    if train:
        g = -torch.log(-torch.log(noise["u"] + eps) + eps)
        c_smp = torch.softmax((torch.log(c + eps) + g) / m["temp"], dim=-1)
    else:
        c_smp = F.one_hot(torch.argmax(c, dim=-1), c.shape[-1]).to(c.dtype)
    y = torch.cat([x_low, c_smp], dim=-1)
    s_mean = linear(params["fc_mu"], y)
    s_logvar = torch.log(torch.sigmoid(linear(params["fc_sigma"], y)) + eps)
    s_smp = s_mean + noise["e"] * torch.sqrt(torch.exp(s_logvar))
    if train:
        s_dec = torch.where(noise["s_keep"], s_smp / (1.0 - m["s_drop"]),
                            torch.zeros((), device=x.device))
    else:
        s_dec = s_smp
    h = torch.relu(linear(params["fc6"], torch.cat([c_smp, s_dec], dim=-1)))
    for name in DECODER:
        h = torch.relu(linear(params[name], h))
    out = {"x_low": x_low, "c_prob": c_prob, "c": c, "c_smp": c_smp,
           "s_mean": s_mean, "s_logvar": s_logvar, "h": h,
           "x_rec": torch.relu(linear(params["fc11"], h))}
    if m["mode"] == "ZINB":
        out["p"] = torch.sigmoid(linear(params["fc11_p"], h))
        out["r"] = torch.sigmoid(linear(params["fc11_r"], h))
    return out


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def recon_mse(x_rec: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per arm 0.5·Σ(x_rec − x)²/B + 0.5·BCE(binarize(x_rec), binarize(x))
    (mmidas/nn_model.py:542-546).  The BCE of two binary tensors is 100
    times the share of mismatched entries (torch clamps its logs at −100)
    and carries no gradient (binarize is a comparison)."""
    B, D = x.shape
    sumsq = ((x_rec - x) ** 2).sum(dim=(1, 2))
    mism = ((x_rec > MISMATCH_THR) != (x > MISMATCH_THR)).sum(dim=(1, 2))
    return 0.5 * sumsq / B + (50.0 * mism / (B * D)).to(sumsq.dtype)


def recon_zinb(rate: torch.Tensor, p: torch.Tensor, z: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Per arm mean zero-inflated negative-binomial NLL of the counts
    k = eˣ − 1 (mmidas/nn_model.py:642-676)."""
    eps = ZINB_EPS
    k = torch.exp(x) - 1.0
    r = rate + eps
    p = (1 - eps) * (p + eps)
    z = (1 - eps) * (z + eps)
    nz = (x > 0).to(x.dtype)
    zero = (nz - 1.0) * torch.log(z + (1.0 - z) * (1.0 - p) ** r)
    nonzero = nz * (-torch.lgamma(k + r) + torch.lgamma(r) - k * torch.log(p)
                    - r * torch.log(1.0 - p) - torch.log(1.0 - z))
    return (zero + nonzero).mean(dim=(1, 2))


def loss(out: dict, x: torch.Tensor, m: dict) -> dict:
    """The cpl-mixVAE loss (mmidas/nn_model.py:495-598), without a prior:

      total = (A−1)·Σ_a (rec_a + β·KL_a) + λ·Σ_{a<b} d(a, b)
            + (A−1)·Σ_a Σ_c c log c + pairs·(C/2·log 2π − ½·log 2λ)

    d(a, b) is the mean over rows of ‖log(c_a+ε)·σ_a⁻¹ − log(c_b+ε)·σ_b⁻¹‖²,
    σ the per-category standard deviation of c over the batch (unbiased)."""
    A, C, eps = m["n_arm"], m["n_categories"], m["eps"]
    if m["mode"] == "ZINB":
        rec = recon_zinb(out["x_rec"], out["p"], out["r"], x)
    else:
        rec = recon_mse(out["x_rec"], x)
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


# ---------------------------------------------------------------------------
# Training step and Adam
# ---------------------------------------------------------------------------

def value_and_grads(params: dict, x: torch.Tensor, m: dict, noise: dict):
    """(total loss, {(layer, leaf): gradient}) of one training step."""
    names = leaf_names(params)
    live = {n: {k: params[n][k].detach().requires_grad_() for k in params[n]}
            for n in params}
    with torch.enable_grad():
        total = loss(forward(live, x, m, True, noise), x, m)["total"]
        grads = torch.autograd.grad(total, [live[n][k] for n, k in names],
                                    allow_unused=True)
    return total.detach(), {nk: (torch.zeros_like(params[nk[0]][nk[1]])
                                 if g is None else g)
                            for nk, g in zip(names, grads)}


def adam_init(params: dict) -> dict:
    return {"t": 0,
            "mu": {nk: torch.zeros_like(params[nk[0]][nk[1]])
                   for nk in leaf_names(params)},
            "nu": {nk: torch.zeros_like(params[nk[0]][nk[1]])
                   for nk in leaf_names(params)}}


@torch.no_grad()
def adam_step(params: dict, grads: dict, state: dict, lr: float) -> None:
    """Adam (Kingma & Ba 2015) in place: eps outside the square root, the
    bias corrections 1 − bᵗ."""
    b1, b2, eps = ADAM["b1"], ADAM["b2"], ADAM["eps"]
    state["t"] += 1
    t = state["t"]
    for (n, k), g in grads.items():
        mu, nu = state["mu"][(n, k)], state["nu"][(n, k)]
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(g * g, alpha=1 - b2)
        mhat = mu / (1 - b1 ** t)
        vhat = nu / (1 - b2 ** t)
        params[n][k].sub_(lr * mhat / (torch.sqrt(vhat) + eps))


def clone_params(params: dict) -> dict:
    return {n: {k: v.detach().clone() for k, v in layer.items()}
            for n, layer in params.items()}


# ---------------------------------------------------------------------------
# Eval of a dataset in batches
# ---------------------------------------------------------------------------

@torch.no_grad()
def evaluate(params: dict, bn: dict, x: torch.Tensor, m: dict,
             batch_size: int, noise_fn) -> dict:
    """Eval of x (N, D) in batches of ``batch_size`` (the last one
    partial): per-row fields (A, N, ·) and the batch-size-weighted losses.
    ``noise_fn(rows)`` gives each batch's (A, rows, S) reparameterisation
    noise.  Labels are the argmax of the sharpened posterior."""
    fields = {"c": [], "c_prob": [], "s_mean": [], "s_logvar": [],
              "x_low": [], "lab": []}
    rec, tot, sizes = [], [], []
    for i in range(0, x.shape[0], batch_size):
        xb = x[i:i + batch_size]
        out = forward(params, xb, m, False, {"e": noise_fn(xb.shape[0])}, bn)
        lo = loss(out, xb, m)
        for k in ("c", "c_prob", "s_mean", "s_logvar", "x_low"):
            fields[k].append(out[k])
        fields["lab"].append(torch.argmax(out["c"], dim=-1))
        rec.append(lo["rec"])
        tot.append(lo["total"])
        sizes.append(xb.shape[0])
        del out, lo
    w = torch.tensor(sizes, dtype=torch.float64, device=x.device)
    res = {k: torch.cat(v, dim=1) for k, v in fields.items()}
    res["total_loss"] = float((torch.stack(tot).double() * w).sum() / w.sum())
    res["total_loss_rec"] = ((torch.stack(rec).double() * w[:, None]).sum(0)
                             / w.sum())
    return res
