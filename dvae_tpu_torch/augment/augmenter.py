"""The frozen VAE-GAN augmenter: a noise-conditioned VAE that gives every
arm its own view of a batch.

Counterpart of the inference half of dvae_tpu/augment/augmenter.py
(reference mmidas/augmentation/udagan.py: ``Augmenter`` :16-118,
``Augmenter_smartseq`` :217-329).  The forward is written directly on
(..., D) tensors; batch norms reduce over all leading axes, so an arm-major
(A, B, D) batch pools its statistics over A·B as the reference's permute
trick does (udagan.py:284-309).  Batch norms: eps 1e-10, momentum 0.01, no
affine; the noise path ``bnz`` is a default ``BatchNorm1d`` (eps 1e-5,
momentum 0.1, affine).  The sigmoid head is used directly as the std of the
reparameterization (mmidas/augmentation/aug_utils.py:51-64).

Architecture (smartseq; D = input_dim, H = n_dim, Z = latent, NZ = noise):
  enc:  drop(x) -> fc1(D, D//5) BN relu -> fc2 BN relu -> fc3(, H) BN relu
        -> fc4(H, H) BN relu -> concat(noise: elu(BNz(W z)))
        -> fc5(H + NZ, H//5) BN relu -> mu = BN(fc_mu), sigma = sigmoid(fc_sigma)
  dec:  s = mu + e * sigma -> fc6(Z, H//5) ... fc10 BN relu -> relu(fc11(, D))
The generic variant differs in the fc5 / fc5_plain split (``noise=False``
takes the plain branch) and both take the ZINB head fc11_p when n_zim > 1.

Every product here is a plain large matrix product that the JAX package
leaves to XLA outside any kernel: they stay ``torch.matmul``.  The three
random draws (the input dropout mask, the noise ``z``, the
reparameterization ``e``) come from a ``torch.Generator`` or, explicitly,
from an ``AugNoise`` bundle, so a test can hand both packages the same
numbers.

The GAN half (dvae_tpu/augment/augmenter.py:268-386): ``kl_dist``, the
plain-VAE ``Generator`` and the ``Discriminator`` that
``augment/train.py`` trains the augmenter against.  Their random draws
(the input dropout's keep-mask; the generator's reparameterization noise)
are explicit arguments too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from dvae_tpu_torch.models.sampling import _draw, dropout

BN_EPS = 1e-10
BN_MOMENTUM = 0.01
# bnz is a torch-default BatchNorm1d in the reference (udagan.py:227):
# eps 1e-5, momentum 0.1, unlike every fc batch norm
_BN_HYPERS = {"bnz": (1e-5, 0.1)}


@dataclass(frozen=True)
class AugmenterConfig:
    noise_dim: int = 50
    latent_dim: int = 10
    input_dim: int = 5032
    n_dim: int = 500            # smartseq default (udagan.py:217); 100 for 10x
    p_drop: float = 0.5
    n_zim: int = 1              # > 1 adds the ZINB dropout head fc11_p
    variant: str = "smartseq"   # "smartseq" | "generic"


class AugNoise(NamedTuple):
    """Explicit random numbers of one augmenter forward; a field left None
    is drawn from the generator.  ``drop_mask``: keep-mask of the input
    dropout, x's shape (train mode only); ``z``: (..., noise_dim) standard
    normals, scaled inside; ``e``: (..., latent_dim) standard normals."""

    drop_mask: Optional[torch.Tensor] = None
    z: Optional[torch.Tensor] = None
    e: Optional[torch.Tensor] = None


def _linear_shapes(cfg: AugmenterConfig) -> dict:
    D, H, Z, NZ = cfg.input_dim, cfg.n_dim, cfg.latent_dim, cfg.noise_dim
    D5, H5 = D // 5, H // 5
    shapes = {
        "noise": (NZ, NZ),          # bias-free (udagan.py:28)
        "fc1": (D, D5), "fc2": (D5, D5), "fc3": (D5, H), "fc4": (H, H),
        "fc5": (H + NZ, H5),
        "fc_mu": (H5, Z), "fc_sigma": (H5, Z),
        "fc6": (Z, H5), "fc7": (H5, H), "fc8": (H, H), "fc9": (H, D5),
        "fc10": (D5, D5), "fc11": (D5, D),
    }
    if cfg.variant == "generic":
        # the generic Augmenter keeps both a plain fc5 (used when
        # noise=False) and the noise-concat one: "fc5" is the reference's
        # fc5n, "fc5_plain" its fc5 (udagan.py:16-118)
        shapes["fc5_plain"] = (H, H5)
    if cfg.n_zim > 1:
        shapes["fc11_p"] = (D5, D)
    return shapes


def _bn_dims(cfg: AugmenterConfig) -> dict:
    D5, H, H5, Z, NZ = (cfg.input_dim // 5, cfg.n_dim, cfg.n_dim // 5,
                        cfg.latent_dim, cfg.noise_dim)
    dims = {"bnz": NZ, "bn1": D5, "bn2": D5, "bn3": H, "bn4": H, "bn5": H5,
            "bn_mu": Z, "bn6": H5, "bn7": H, "bn8": H, "bn9": D5, "bn10": D5}
    if cfg.variant == "generic":
        dims["bn5_plain"] = H5  # the plain branch keeps its own statistics
    return dims


def _init_linears(generator: torch.Generator, shapes: dict, device, dtype):
    """``nn.Linear``'s default init, U(±1/sqrt(fan_in)) for weight and bias,
    drawn in ``shapes``' order on the generator's device."""
    params = {}
    for name, (fan_in, fan_out) in shapes.items():
        bound = 1.0 / fan_in ** 0.5
        params[name] = {
            leaf: ((2.0 * torch.rand(shape, generator=generator,
                                     device=generator.device) - 1.0)
                   * bound).to(device=device, dtype=dtype)
            for leaf, shape in (("w", (fan_in, fan_out)), ("b", (fan_out,)))}
    return params


def _bn_init(dims: dict, device, dtype):
    return {name: {"mean": torch.zeros(d, device=device, dtype=dtype),
                   "var": torch.ones(d, device=device, dtype=dtype)}
            for name, d in dims.items()}


def init_augmenter(generator: torch.Generator, cfg: AugmenterConfig,
                   device="cpu", dtype=torch.float32):
    """(params, bn_state) with ``nn.Linear``'s default init; the numbers
    are drawn on the generator's device and moved to ``device``."""
    params = _init_linears(generator, _linear_shapes(cfg), device, dtype)
    params["noise"]["b"] = None  # bias-free (udagan.py:28)
    bn = _bn_init(_bn_dims(cfg), device, dtype)
    # bnz is affine
    bn["bnz"]["scale"] = torch.ones(cfg.noise_dim, device=device, dtype=dtype)
    bn["bnz"]["bias"] = torch.zeros(cfg.noise_dim, device=device, dtype=dtype)
    return params, bn


def _lin(p, x):
    y = x @ p["w"]
    return y if p["b"] is None else y + p["b"]


def _bn(x, stats, train: bool, eps: float = BN_EPS,
        momentum: float = BN_MOMENTUM):
    """Normalise over all leading axes (an arm-major batch pools over A·B).
    The statistics are computed in the running statistics' dtype (f32); the
    output returns in the activation's.  Returns (y, new stats): in train
    mode the batch statistics (biased variance) normalise and the running
    ones take the unbiased variance; else the running ones normalise."""
    xf = x.to(stats["mean"].dtype)
    if train:
        red = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=red)
        var = xf.var(dim=red, unbiased=False)
        n = x.numel() // x.shape[-1]
        new = dict(stats)
        new["mean"] = (1 - momentum) * stats["mean"] + momentum * mean
        new["var"] = ((1 - momentum) * stats["var"]
                      + momentum * var * (n / max(n - 1, 1)))
    else:
        mean, var, new = stats["mean"], stats["var"], stats
    y = (xf - mean) * torch.rsqrt(var + eps)
    if "scale" in stats:
        y = y * stats["scale"] + stats["bias"]
    return y.to(x.dtype), new


def _noise_concat(params, bn_fn, cfg: AugmenterConfig, h, scale, generator,
                  z):
    """z draw + elu(BNz(W z)) + concat + fc5 (udagan.py:288-296)."""
    if z is None:
        z = _draw("normal", h.shape[:-1] + (cfg.noise_dim,), h, generator)
    z = scale * z.to(h.dtype)
    z = bn_fn("bnz", _lin(params["noise"], z), act=torch.nn.functional.elu)
    return bn_fn("bn5", _lin(params["fc5"], torch.cat([h, z], dim=-1)))


def _latent_decode(params, bn_fn, h, generator, e, zinb_head: bool,
                   inplace: bool = False):
    """fc_mu/fc_sigma reparameterization + the fc6..fc11 decoder
    (udagan.py:297-309), shared by ``apply_augmenter`` and ``augment_arms``.
    Returns (s, x_mu, x_p | None).  ``inplace`` adds fc11's bias and applies
    its ReLU where the product was written: the output is the one tensor of
    its size (no autograd through it)."""
    mu = bn_fn("bn_mu", _lin(params["fc_mu"], h), act=None)
    sigma = torch.sigmoid(_lin(params["fc_sigma"], h))
    if e is None:
        e = _draw("normal", mu.shape, mu, generator)
    s = mu + e.to(mu.dtype) * sigma

    h = bn_fn("bn6", _lin(params["fc6"], s))
    for fc, norm in (("fc7", "bn7"), ("fc8", "bn8"), ("fc9", "bn9"),
                     ("fc10", "bn10")):
        h = bn_fn(norm, _lin(params[fc], h))
    if inplace:
        x_mu = (h @ params["fc11"]["w"]).add_(params["fc11"]["b"]).relu_()
    else:
        x_mu = torch.relu(_lin(params["fc11"], h))
    x_p = torch.sigmoid(_lin(params["fc11_p"], h)) if zinb_head else None
    return s, x_mu, x_p


def apply_augmenter(params, bn, cfg: AugmenterConfig, x: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False, noise: bool = True,
                    scale: float = 1.0, draws: AugNoise = AugNoise()):
    """Forward.  ``x``: (..., D), a (B, D) batch or arm-major (A, B, D).

    Returns (s, x_out, new_bn) with x_out (..., D), or (..., 2D) when
    n_zim > 1: [x_mu, x_p] concatenated like udagan.py:112-115.
    """
    new_bn = dict(bn)

    def bnr(name, h, act=torch.relu):
        eps, mom = _BN_HYPERS.get(name, (BN_EPS, BN_MOMENTUM))
        y, new_bn[name] = _bn(h, bn[name], train, eps, mom)
        return act(y) if act else y

    h = x
    if train and (cfg.p_drop > 0 or draws.drop_mask is not None):
        h = dropout(x, cfg.p_drop, generator, draws.drop_mask)
    for fc, norm in (("fc1", "bn1"), ("fc2", "bn2"), ("fc3", "bn3"),
                     ("fc4", "bn4")):
        h = bnr(norm, _lin(params[fc], h))

    if cfg.variant == "smartseq":
        # smartseq has no deterministic branch (udagan.py:247-251): its
        # noise-off forward is the same fc5 path with a zero z
        h = _noise_concat(params, bnr, cfg, h, scale if noise else 0.0,
                          generator, draws.z)
    elif noise:
        h = _noise_concat(params, bnr, cfg, h, scale, generator, draws.z)
    else:
        h = bnr("bn5_plain", _lin(params["fc5_plain"], h))

    s, x_mu, x_p = _latent_decode(params, bnr, h, generator, draws.e,
                                  zinb_head=cfg.n_zim > 1)
    if x_p is not None:
        return s, torch.cat([x_mu, x_p], dim=-1), new_bn
    return s, x_mu, new_bn


@torch.no_grad()
def augment_arms(params, bn, cfg: AugmenterConfig, x: torch.Tensor,
                 n_arm: int, scale: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 draws: AugNoise = AugNoise()) -> torch.Tensor:
    """Frozen-augmenter per-arm views: (B, D) -> (A, B, D), the call inside
    the training loop (reference cpl_mixvae.py:422-425, the augmenter in
    eval mode: frozen weights, running batch-norm statistics).

    In eval mode dropout is the identity and batch norm reads running
    statistics, so the fc1–fc4 trunk does not depend on the arm: it runs
    once on (B, D) and is broadcast; the arms part at the per-arm noise
    concat before fc5.  The result equals ``apply_augmenter`` on the
    broadcast batch with the same draws.  The ZINB head's output would be
    discarded here, so it is skipped; an n_zim > 1 augmenter's views are
    masked to where the original was nonzero.  The (A, B, D) result is the
    only tensor of its size: fc11's bias, its ReLU and the mask are applied
    in place.
    """
    def ev(name, h, act=torch.relu):
        eps, mom = _BN_HYPERS.get(name, (BN_EPS, BN_MOMENTUM))
        y, _ = _bn(h, bn[name], False, eps, mom)
        return act(y) if act else y

    h = x
    for fc, norm in (("fc1", "bn1"), ("fc2", "bn2"), ("fc3", "bn3"),
                     ("fc4", "bn4")):
        h = ev(norm, _lin(params[fc], h))
    h = h.expand(n_arm, *h.shape)
    h = _noise_concat(params, ev, cfg, h, scale, generator, draws.z)
    _, x_mu, _ = _latent_decode(params, ev, h, generator, draws.e,
                                zinb_head=False, inplace=True)
    if cfg.n_zim > 1:
        x_mu.mul_((x > 0).to(x_mu.dtype))
    return x_mu


def kl_dist(mu1, var1, mu2, var2, eps: float = 1e-6):
    """KL divergence between two diagonal Gaussians, summed over dims and
    averaged over the batch (reference ``KL_dist``,
    mmidas/augmentation/aug_utils.py:20-27)."""
    logli = (torch.log((var2 + eps) / (var1 + eps))
             + (var1 + (mu1 - mu2) ** 2) / (2.0 * var2 + eps) - 0.5)
    return logli.sum(dim=1).mean()


@dataclass(frozen=True)
class GeneratorConfig:
    """The reference ``Generator`` (udagan.py:148-214): a plain VAE with its
    own narrower topology, fc1 (D -> n_dim), fc2/fc3, mu/sigma from n_dim,
    the decoder fc6/fc7/fc10 (no noise path).  No reference entry point uses
    it; it is part of the module's surface."""

    latent_dim: int = 10
    input_dim: int = 5032
    n_dim: int = 100
    n_zim: int = 1
    p_drop: float = 0.1


def init_generator(generator: torch.Generator, cfg: GeneratorConfig,
                   device="cuda", dtype=torch.float32):
    """(params, bn_state) for ``apply_generator``, drawn on the
    generator's device and moved to ``device``."""
    D, H, Z = cfg.input_dim, cfg.n_dim, cfg.latent_dim
    shapes = {"fc1": (D, H), "fc2": (H, H), "fc3": (H, H),
              "fc_mu": (H, Z), "fc_sigma": (H, Z),
              "fc6": (Z, H), "fc7": (H, H), "fc10": (H, H), "fc11": (H, D)}
    if cfg.n_zim > 1:
        shapes["fc11_p"] = (H, D)
    dims = {"bn1": H, "bn2": H, "bn3": H, "bn_mu": Z, "bn6": H, "bn7": H,
            "bn10": H}
    return (_init_linears(generator, shapes, device, dtype),
            _bn_init(dims, device, dtype))


def apply_generator(params, bn, cfg: GeneratorConfig, x: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False, draws: AugNoise = AugNoise()):
    """Forward (udagan.py:198-213).  Returns (s, x_out, new_bn); x_out is
    (..., 2D) [x_mu, x_p] when n_zim > 1.  ``draws.drop_mask`` and
    ``draws.e`` are the explicit dropout keep-mask and reparameterization
    noise (``draws.z`` is unused: the generator has no noise path)."""
    new_bn = dict(bn)

    def bnr(name, h, act=torch.relu):
        y, new_bn[name] = _bn(h, bn[name], train)
        return act(y) if act else y

    h = x
    if train and (cfg.p_drop > 0 or draws.drop_mask is not None):
        h = dropout(x, cfg.p_drop, generator, draws.drop_mask)
    for fc, norm in (("fc1", "bn1"), ("fc2", "bn2"), ("fc3", "bn3")):
        h = bnr(norm, _lin(params[fc], h))
    mu = bnr("bn_mu", _lin(params["fc_mu"], h), act=None)
    sigma = torch.sigmoid(_lin(params["fc_sigma"], h))
    e = draws.e
    if e is None:
        e = _draw("normal", mu.shape, mu, generator)
    s = mu + e.to(mu.dtype) * sigma
    h = s
    for fc, norm in (("fc6", "bn6"), ("fc7", "bn7"), ("fc10", "bn10")):
        h = bnr(norm, _lin(params[fc], h))
    x_mu = torch.relu(_lin(params["fc11"], h))
    if cfg.n_zim > 1:
        x_p = torch.sigmoid(_lin(params["fc11_p"], h))
        return s, torch.cat([x_mu, x_p], dim=-1), new_bn
    return s, x_mu, new_bn


# ---------------------------------------------------------------------------
# Discriminator (udagan.py:121-145)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DiscriminatorConfig:
    input_dim: int = 5032
    p_drop: float = 0.2


def init_discriminator(generator: torch.Generator, cfg: DiscriminatorConfig,
                       device="cuda", dtype=torch.float32):
    """(params, bn_state) on ``device``: fc1 (D, D//5), fc2 (D//5, D//5),
    disc (D//5, 1); batch norms bn1, bn2 without affine."""
    D5 = cfg.input_dim // 5
    shapes = {"fc1": (cfg.input_dim, D5), "fc2": (D5, D5), "disc": (D5, 1)}
    return (_init_linears(generator, shapes, device, dtype),
            _bn_init({"bn1": D5, "bn2": D5}, device, dtype))


def apply_discriminator(params, bn, cfg: DiscriminatorConfig,
                        x: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        train: bool = False,
                        drop_mask: Optional[torch.Tensor] = None):
    """Returns (features, probs, new_bn): dropout (train mode; the keep-mask
    ``drop_mask`` or one drawn from ``generator``), two fc + batch norm +
    ReLU layers, a sigmoid head of one unit."""
    new_bn = dict(bn)
    h = x
    if train and (cfg.p_drop > 0 or drop_mask is not None):
        h = dropout(x, cfg.p_drop, generator, drop_mask)
    h, new_bn["bn1"] = _bn(_lin(params["fc1"], h), bn["bn1"], train)
    h = torch.relu(h)
    h, new_bn["bn2"] = _bn(_lin(params["fc2"], h), bn["bn2"], train)
    h = torch.relu(h)
    probs = torch.sigmoid(_lin(params["disc"], h))
    return h, probs, new_bn


# ---------------------------------------------------------------------------
# Checkpoints and the closures the training loop takes
# ---------------------------------------------------------------------------

def save_augmenter(path: str, params, bn, cfg: AugmenterConfig,
                   extra: Optional[dict] = None) -> str:
    """Write the augmenter in the JAX package's checkpoint format, the
    hyperparameters in the metadata (dvae_tpu/augment/augmenter.py:388)."""
    from dvae_tpu_torch.utils.checkpoint import save_checkpoint
    meta = {"cfg": dict(cfg.__dict__), **(extra or {})}
    return save_checkpoint(path, {"params": params, "bn": bn}, meta)


def load_augmenter(path: str, device="cpu", dtype=torch.float32):
    """(params, bn, cfg) of an augmenter checkpoint written by either
    package, the weights in ``dtype`` (stored bf16 weights widen exactly)."""
    from dvae_tpu_torch.utils.checkpoint import (augmenter_from_jax,
                                                 load_checkpoint)
    tree, meta = load_checkpoint(path)
    params, bn = augmenter_from_jax(tree["params"], tree["bn"], device, dtype)
    return params, bn, AugmenterConfig(**meta["cfg"])


def cast_augmenter_params(params, dtype=None):
    """Cast the weights (None = identity); the batch-norm statistics stay
    f32."""
    if dtype is None:
        return params
    return {name: {k: (None if v is None else v.to(dtype))
                   for k, v in layer.items()}
            for name, layer in params.items()}


def make_augment_apply(params, bn, cfg: AugmenterConfig, dtype=None):
    """Frozen closure over in-memory augmenter weights:
    fn(x, n_arm, scale=0.1, generator=None, draws=AugNoise()) -> (A, B, D).
    ``dtype`` casts the weights once (bf16 under mixed-precision training;
    ``_bn`` computes in the statistics' f32 and returns the activation's
    dtype)."""
    params = cast_augmenter_params(params, dtype)

    def fn(x, n_arm, scale=0.1, generator=None, draws=AugNoise()):
        return augment_arms(params, bn, cfg, x, n_arm, scale, generator,
                            draws)
    return fn


def frozen_random_augment_fn(input_dim: int, bf16: bool = False, n_dim=None,
                             seed: int = 7, scale: float = 0.1,
                             device="cuda"):
    """Random-weight frozen augmenter closure fn(x, n_arm, generator=None,
    draws=AugNoise()) -> (A, B, D): the forward cost of a trained augmenter
    without shipping a checkpoint.  ``n_dim`` overrides the hidden width
    for small shapes."""
    kw = {"input_dim": input_dim}
    if n_dim is not None:
        kw["n_dim"] = n_dim
    acfg = AugmenterConfig(**kw)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params, bn = init_augmenter(gen, acfg, device=device)
    apply = make_augment_apply(params, bn, acfg,
                               torch.bfloat16 if bf16 else None)

    def fn(x, n_arm, generator=None, draws=AugNoise()):
        return apply(x, n_arm, scale, generator, draws)
    return fn


def load_augmenter_apply(path: str, dtype=None, device="cuda"):
    """``make_augment_apply`` over a checkpoint file (reference
    ``mk_augmenter``, cpl_mixvae.py:128-149)."""
    params, bn, cfg = load_augmenter(path, device)
    return make_augment_apply(params, bn, cfg, dtype)
