"""Typed functional inference API of the PyTorch port.

Counterpart of dvae_tpu/models/api.py (reference ``mmidas/model.py``):
``generate`` :77-149 (batched inference dict, the reconstruction
included), ``load_vae`` :176-181, ``mk_run``/``mk_config``/
``get_weights``/``load_weights`` :199-239 (checkpoint discovery by glob
and largest epoch), ``single_vae_apply`` (``VAE`` :242-294, one arm run
alone) and the small helpers.

``load_vae`` reads a checkpoint written by either package onto
``device`` (default ``"cuda"``; pass ``"cpu"`` explicitly).  ``generate``
runs the eval forward and the plain loss on the weights' device, batch by
batch: the loss is the unfused one because ``generate`` returns the
reconstruction, so under ``cfg.use_pallas`` the only kernel it launches
on the card is the fused coupling distance, once a batch.  Its
reparameterisation noise comes from a ``torch.Generator`` (a CPU one by
default, so the numbers do not depend on the device) or from explicit
draws, one tensor a batch.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional, Sequence

import numpy as np
import torch

from dvae_tpu_torch.config import VAEConfig
from dvae_tpu_torch.models import mixvae
from dvae_tpu_torch.models.losses import mixvae_loss
from dvae_tpu_torch.train.cpl_mixvae import _resolve_device
from dvae_tpu_torch.utils.checkpoint import (bn_from_jax, latest_checkpoint,
                                             load_checkpoint, params_from_jax,
                                             parse_epoch)


def mk_config(**kw) -> VAEConfig:
    """Config constructor (reference mk_config, model.py:199-210)."""
    return VAEConfig(**kw)


def is_normalized(xs, atol: float = 1e-6) -> torch.Tensor:
    """Whether each last-axis slice sums to 1 within ``atol`` (reference
    ``is_normalized``, model.py:48-55, exact there)."""
    xs = torch.as_tensor(xs)
    return (xs.sum(dim=-1) - 1.0).abs() <= atol


def clr(prob) -> torch.Tensor:
    """Centred log-ratio of rows on the probability simplex, ``log p −
    mean(log p)`` over the last axis (reference ``clr``, model.py:57-58,
    which only validated its input); rows off the simplex raise."""
    prob = torch.as_tensor(prob)
    if not bool(((prob >= 0) & (prob <= 1)).all()) or not bool(
            is_normalized(prob).all()):
        raise ValueError("clr expects rows on the probability simplex")
    logp = torch.log(prob)
    return logp - logp.mean(dim=-1, keepdim=True)


def mk_run(folder: str) -> dict:
    """A run folder's latest checkpoint and its epoch (reference
    mk_run/get_weights, model.py:211-229)."""
    ckpt = latest_checkpoint(folder)
    return {"folder": folder, "checkpoint": ckpt,
            "epoch": parse_epoch(ckpt) if ckpt else -1}


def get_weights(folder: str, device="cuda"):
    """``load_weights`` of a run folder's latest checkpoint."""
    ckpt = latest_checkpoint(folder)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {folder}")
    return load_weights(ckpt, device)


def load_weights(path: str, device="cuda"):
    """(params, bn, mask | None, metadata) of a checkpoint written by either
    package, the tensors on ``device``."""
    dev = _resolve_device(device)
    tree, meta = load_checkpoint(path)
    mask = tree.get("mask")
    if mask is not None:
        mask = torch.from_numpy(np.array(mask)).to(dev)
    return (params_from_jax(tree["params"], dev), bn_from_jax(tree["bn"], dev),
            mask, meta)


def load_vae(path: str, cfg: Optional[VAEConfig] = None, device="cuda"):
    """(cfg, params, bn, mask) from a checkpoint of either package
    (reference load_vae, model.py:176-181).  Without ``cfg`` the config is
    rebuilt from the checkpoint's metadata, fields this package does not
    know dropped; a checkpoint without a mask gets an all-ones one."""
    params, bn, mask, meta = load_weights(path, device)
    if cfg is None:
        cfg_dict = dict(meta.get("cfg", {}))
        if not cfg_dict:
            raise ValueError(f"{path} stores no config; pass cfg=")
        known = {f.name for f in dataclasses.fields(VAEConfig)}
        cfg = VAEConfig(**{k: v for k, v in cfg_dict.items() if k in known})
    if mask is None:
        mask = torch.ones(cfg.n_categories, device=params["fc1"]["w"].device)
    return cfg, params, bn, mask


_GENERATE_KEYS = ("recon", "c_prob", "c_smp", "state", "state_mu",
                  "state_logvar", "x_low", "pred_label")


def _tile_pad(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``a`` followed by ``rows`` more rows repeating its own, in order
    (dvae_tpu/models/api.py:152-154)."""
    reps = -(-rows // a.shape[0])
    return torch.cat([a] * (reps + 1))[: a.shape[0] + rows]


def generate(cfg: VAEConfig, params, bn, x,
             mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             temp: float = 1.0, batch_size: int = 5000,
             c_p: Optional[np.ndarray] = None,
             pad_final: bool = True,
             noise: Optional[Sequence[torch.Tensor]] = None) -> dict:
    """Batched inference dict (reference ``generate``, model.py:77-149;
    dvae_tpu/models/api.py:111-179), on the device of ``params``.

    Returns numpy arrays under the JAX package's keys: 'recon' (A, N, D),
    'c_prob' (A, N, C, the sharpened posterior), 'c_smp', 'state'
    (A, N, S), 'state_mu', 'state_logvar', 'x_low', 'pred_label' (A, N) and
    'loss_rec' (A,), the batch-size weighted mean over batches.  Each
    batch's outputs leave the device before the next batch runs.

    ``c_p``: the (N, C) reference prior, required when ``cfg.ref_prior``.
    ``pad_final``: a partial last batch is padded with its own rows to
    ``batch_size``, as the JAX package pads to keep one compiled shape;
    the arrays are cut back to N rows and only that batch's 'loss_rec'
    averages over the repeated rows, so both packages' numbers agree.
    ``False`` evaluates the ragged batch as it is.
    ``generator``: draws each batch's (A, rows, S) reparameterisation
    noise in turn (default: a CPU generator seeded 0); ``noise`` gives
    those draws instead, one tensor a batch, its rows those of the padded
    batch."""
    if cfg.ref_prior and c_p is None:
        raise ValueError(
            "cfg.ref_prior is set: pass c_p= (the (N, C) prior the state "
            "head was trained on)")
    dev = params["fc1"]["w"].device
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if mask is None:
        mask = torch.ones(cfg.n_categories, device=dev)
    n = x.shape[0]
    out: dict = {}
    recs, sizes = [], []
    for j, i in enumerate(range(0, n, batch_size)):
        xb = torch.as_tensor(x[i: i + batch_size]).to(dev, torch.float32)
        pb = (None if c_p is None else
              torch.as_tensor(np.asarray(c_p[i: i + batch_size]))
              .to(dev, torch.float32))
        nb = xb.shape[0]
        if pad_final and nb < batch_size:
            xb = _tile_pad(xb, batch_size - nb)
            if pb is not None:
                pb = _tile_pad(pb, batch_size - nb)
        e = None if noise is None else torch.as_tensor(noise[j]).to(dev)
        vals, rec = _generate_batch(cfg, params, bn, xb, mask, pb, temp, e,
                                    generator, nb)
        for k, v in vals.items():
            if k not in out:
                out[k] = np.empty((v.shape[0], n) + v.shape[2:], v.dtype)
            out[k][:, i: i + nb] = v
        recs.append(rec)
        sizes.append(nb)
    out["loss_rec"] = np.average(recs, axis=0, weights=sizes)
    return out


@torch.no_grad()
def _generate_batch(cfg, params, bn, xb, mask, pb, temp, e, generator,
                    nb: int):
    """One batch of ``generate``: the outputs' first ``nb`` rows and the
    (A,) loss_rec, as numpy.  Its device tensors die when it returns, so
    no batch's (A, B, D) reconstruction lives on into the next batch."""
    outs, _ = mixvae.apply(params, bn, cfg, xb, temp=temp, train=False,
                           mask=mask, prior_c=pb, noise=e,
                           generator=generator)
    aux = mixvae_loss(cfg, outs, xb, prior_c=pb)
    vals = (outs.x_rec, outs.c, outs.c_smp, outs.s_smp, outs.s_mean,
            outs.s_logvar, outs.x_low, torch.argmax(outs.c, dim=-1))
    return ({k: v[:, :nb].cpu().numpy() for k, v in zip(_GENERATE_KEYS, vals)},
            aux.loss_rec.float().cpu().numpy())


def single_vae_apply(cfg: VAEConfig, params_one_arm, bn_one_arm, x,
                     train: bool = False, noise=None,
                     generator: Optional[torch.Generator] = None):
    """One arm's VAE alone (reference ``VAE``, model.py:242-294): the arm's
    unstacked parameters and statistics run as a one-arm model on x
    (B, D).  Returns (MixVAEOutputs without the arm axis, bn of the arm);
    ``noise`` is an explicit (B, S) reparameterisation draw."""
    params = {n: {k: (None if v is None else v[None]) for k, v in layer.items()}
              for n, layer in params_one_arm.items()}
    bn = {n: {k: v[None] for k, v in st.items()}
          for n, st in bn_one_arm.items()}
    if isinstance(noise, torch.Tensor):
        noise = noise[None]
    outs, new_bn = mixvae.apply(params, bn, cfg.replace(n_arm=1), x,
                                train=train, noise=noise, generator=generator)
    return (mixvae.MixVAEOutputs(*(o[0] for o in outs)),
            {n: {k: v[0] for k, v in st.items()} for n, st in new_bn.items()})


def view_weights(folder: str, device="cuda") -> dict:
    """Shapes and dtypes of a run's latest parameters (reference
    ``view_weights``, model.py:231-234): ``{'summary': {path: (shape,
    dtype)}, 'params', 'metadata'}``, the paths spelled as
    ``jax.tree_util.keystr`` spells them."""
    params, _, _, meta = get_weights(folder, device)
    summary = {f"[{n!r}][{k!r}]": (tuple(v.shape),
                                   str(v.dtype).replace("torch.", ""))
               for n in sorted(params) for k, v in sorted(params[n].items())
               if v is not None}
    return {"summary": summary, "params": params, "metadata": meta}


def sample_normal(generator: Optional[torch.Generator] = None) -> float:
    """One standard-normal draw by Box–Muller (reference ``sample_normal``,
    model.py:28-29): from two uniforms of ``generator``, or of Python's
    ``random`` without one."""
    if generator is not None:
        u1, u2 = torch.rand(2, generator=generator,
                            device=generator.device).tolist()
        return math.sqrt(-2 * math.log(1.0 - u1)) * math.cos(2 * math.pi * u2)
    return (math.sqrt(-2 * math.log(random.random()))
            * math.cos(2 * math.pi * random.random()))


def reparam(mean, logvar, generator: Optional[torch.Generator] = None,
            e: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian reparameterisation ``mean + e·exp(logvar / 2)`` (reference
    ``reparam``, model.py:60-61), ``e`` given or N(0, 1) from
    ``generator``."""
    mean = torch.as_tensor(mean)
    if e is None:
        dev = generator.device if generator is not None else mean.device
        e = torch.randn(mean.shape, generator=generator, device=dev)
    return mean + e.to(mean) * torch.exp(0.5 * torch.as_tensor(logvar))
