"""Import reference PyTorch ``.pth`` checkpoints (MMIDAS) into the checkpoint
format that both packages load.

Counterpart of dvae_tpu/utils/torch_import.py.  A user of the reference
PyTorch MMIDAS holds

  * trainer checkpoints ``{"model_state_dict", "optimizer_state_dict"}``
    (mmidas/cpl_mixvae.py:777-788) with per-arm ``nn.ModuleList`` names
    ``fc1.{arm}.weight`` … ``fc11.{arm}.bias`` (ZINB heads ``fc11_p`` /
    ``fc11_r``; mmidas/nn_model.py:184-206) and the batch-norm buffers
    ``batch_l{1..5}.{arm}.running_mean/running_var`` (:208-247);
  * augmenter checkpoints ``{"netA", "netD", "optimA", "optimD",
    "parameters"}`` (mmidas/augmentation/train.py:139-147) with the
    ``Augmenter_smartseq`` layer names (udagan.py:217-283) and the
    hyperparameters that ``mk_augmenter`` reads (cpl_mixvae.py:128-149).

The conversions are the JAX package's, in numpy, so both importers write
the same bytes: ``nn.Linear.weight`` (out, in) is transposed to (in, out);
per-arm entries are stacked on a leading arm axis; a
``torch.nn.utils.prune`` reparameterisation (``weight_orig`` ×
``weight_mask``) is folded into the weight and the (C,) category mask is
read from ``fcc``'s row mask; torch Adam's ``exp_avg``/``exp_avg_sq``/
``step`` become the port's ``AdamState`` (``mu``/``nu``/``count``; both
correct the bias at update time), written under optax's names as every
checkpoint of the port is; the model's sizes and mode come from the
tensors' shapes.  Wrapper name segments (DDP ``module``, FSDP
``_fsdp_wrapped_module``, compile ``_orig_mod``) are dropped.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dvae_tpu_torch.utils.checkpoint import (adam_state_to_jax, parse_epoch,
                                             save_checkpoint)

# the mixVAE's linear names are the reference ModuleList names
# (models/mixvae._arm_shapes); the batch norms map to its buffers
_MIXVAE_BN = {"bn1": "batch_l1", "bn2": "batch_l2", "bn3": "batch_l3",
              "bn4": "batch_l4", "bn5": "batch_l5"}

# the augmenter's names (augment/augmenter._linear_shapes, _bn_dims) →
# reference Augmenter_smartseq attribute names (udagan.py:217-283)
_AUG_LINEAR = {name: name for name in (
    "noise", "fc1", "fc2", "fc3", "fc4", "fc5", "fc_mu", "fc_sigma",
    "fc6", "fc7", "fc8", "fc9", "fc10", "fc11")}
_AUG_BN = {"bnz": "bnz", "bn_mu": "batch_fc_mu",
           **{f"bn{i}": f"batch_fc{i}" for i in range(1, 11)}}

_MIXVAE_LINEAR = ("fc1", "fc2", "fc3", "fc4", "fc5", "fcc", "fc_mu",
                  "fc_sigma", "fc6", "fc7", "fc8", "fc9", "fc10", "fc11")
_ZINB_HEADS = ("fc11_p", "fc11_r")


def _load_torch(path: str) -> dict:
    """The checkpoint dict, every tensor on the CPU."""
    import torch
    return torch.load(path, map_location="cpu", weights_only=False)


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


_WRAPPER_SEGMENTS = frozenset(
    {"module", "_fsdp_wrapped_module", "_orig_mod",
     "_checkpoint_wrapped_module"})


def _strip_prefixes(sd: dict) -> dict:
    """Names without wrapper segments (whole dotted segments only: a layer
    whose own name merely contains one is untouched), in the same order."""
    return {".".join(seg for seg in k.split(".")
                     if seg not in _WRAPPER_SEGMENTS): v
            for k, v in sd.items()}


def _linear(sd: dict, key: str):
    """(weight, bias | None) of a linear layer, a pruning
    reparameterisation folded (weight = weight_orig · weight_mask)."""
    if f"{key}.weight" in sd:
        w = _np(sd[f"{key}.weight"])
    else:
        w = _np(sd[f"{key}.weight_orig"]) * _np(sd[f"{key}.weight_mask"])
    b = sd.get(f"{key}.bias")
    if b is None and f"{key}.bias_orig" in sd:
        b = _np(sd[f"{key}.bias_orig"]) * _np(sd[f"{key}.bias_mask"])
    return w, (None if b is None else _np(b))


# ---------------------------------------------------------------------------
# mixVAE trainer checkpoints
# ---------------------------------------------------------------------------

def mixvae_from_state_dict(sd: dict):
    """(params, bn, mask, inferred sizes) of a reference
    ``model_state_dict``, numpy trees in the stacked-arm layout."""
    sd = _strip_prefixes(sd)
    n_arm = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("fc1."))
    zinb = "fc11_p.0.weight" in sd or "fc11_p.0.weight_orig" in sd
    names = _MIXVAE_LINEAR + (_ZINB_HEADS if zinb else ())
    params = {}
    for name in names:
        ws, bs = [], []
        for a in range(n_arm):
            w, b = _linear(sd, f"{name}.{a}")
            ws.append(w.T)
            bs.append(b)
        params[name] = {"w": np.stack(ws), "b": np.stack(bs)}
    bn = {ours: {"mean": np.stack([_np(sd[f"{ref}.{a}.running_mean"])
                                   for a in range(n_arm)]),
                 "var": np.stack([_np(sd[f"{ref}.{a}.running_var"])
                                  for a in range(n_arm)])}
          for ours, ref in _MIXVAE_BN.items()}
    C = params["fcc"]["w"].shape[-1]
    if "fcc.0.weight_mask" in sd:
        # category c is pruned when its fcc output row is masked whole
        row_mask = _np(sd["fcc.0.weight_mask"])          # (C, L)
        mask = (np.abs(row_mask).sum(axis=1) > 0).astype(np.float32)
    else:
        mask = np.ones((C,), np.float32)
    D, F = params["fc1"]["w"].shape[1:]
    inferred = dict(n_arm=n_arm, input_dim=D, fc_dim=F,
                    lowD_dim=params["fc5"]["w"].shape[-1], n_categories=C,
                    state_dim=params["fc_mu"]["w"].shape[-1],
                    mode="ZINB" if zinb else "MSE")
    return params, bn, mask, inferred


def _zeros_like(params: dict) -> dict:
    return {n: {k: np.zeros_like(v) for k, v in layer.items()}
            for n, layer in params.items()}


def _adam_state_from_torch(opt_sd: dict, params: dict, sd_keys):
    """(count, mu, nu) of torch Adam's state laid onto ``params``, or None
    when the mapping fails.

    Torch numbers the parameters by their place in ``model.parameters()``.
    The slots follow the ``model_state_dict``'s key order (``sd_keys``),
    which is the modules' registration order and so ``parameters()``'s for
    the linear weights and biases (the batch norms have no affine
    parameters, only buffers, which are skipped): same-shaped layers
    (fc2/fc3/fc4, fc_mu/fc_sigma, fc11_p/fc11_r) keep their own moments
    where a shape check could not tell them apart.  A pruning
    reparameterisation changes that order, so its moments are not mapped.
    """
    slots = []          # (name, "w" | "b", arm) in parameters() order
    for k in sd_keys:
        parts = k.split(".")
        if len(parts) != 3 or parts[0] not in params:
            continue
        name, arm, kind = parts[0], int(parts[1]), parts[2]
        if kind in ("weight", "weight_orig"):
            slots.append((name, "w", arm))
        elif kind in ("bias", "bias_orig"):
            slots.append((name, "b", arm))
        elif kind.endswith("_mask"):
            return None
    state = opt_sd.get("state", {})
    if len(state) != len(slots):
        return None
    mu, nu = _zeros_like(params), _zeros_like(params)
    count = 0
    for idx, (name, kind, a) in enumerate(slots):
        s = state.get(idx)
        if s is None or "exp_avg" not in s:
            return None
        m, v = _np(s["exp_avg"]), _np(s["exp_avg_sq"])
        if kind == "w":
            m, v = m.T, v.T
        if m.shape != params[name][kind][a].shape:
            return None
        mu[name][kind][a] = m
        nu[name][kind][a] = v
        count = max(count, int(_np(s["step"])))
    return count, mu, nu


def import_mixvae_checkpoint(path: str, out_path: Optional[str] = None,
                             import_optimizer: bool = True,
                             ckpt: Optional[dict] = None) -> str:
    """Convert a reference trainer ``.pth`` into a checkpoint that
    ``CplMixVAE.load_model`` (and ``init_model(trained_model=…)``,
    ``models.api.load_vae``) of either package reads.  ``ckpt`` may pass
    the dict already loaded.  Returns the written path (by default beside
    the input, ``.ckpt``)."""
    ckpt = _load_torch(path) if ckpt is None else ckpt
    sd = ckpt["model_state_dict"] if "model_state_dict" in ckpt else ckpt
    params, bn, mask, inferred = mixvae_from_state_dict(sd)
    lr = 1e-3
    opt_sd = ckpt.get("optimizer_state_dict")
    if opt_sd and opt_sd.get("param_groups"):
        lr = float(opt_sd["param_groups"][0].get("lr", lr))
    adam = None
    if import_optimizer and opt_sd:
        adam = _adam_state_from_torch(opt_sd, params,
                                      list(_strip_prefixes(sd)))
        if adam is None:
            print("WARNING: could not map the torch Adam moments onto the "
                  "stacked-arm layout (pruned-checkpoint reparametrization, "
                  "slot-count or shape mismatch) — resuming with a FRESH "
                  "optimizer state; loss may transiently spike.")
    moments_imported = adam is not None
    if adam is None:
        adam = (0, _zeros_like(params), _zeros_like(params))
    out_path = out_path or os.path.splitext(path)[0] + ".ckpt"
    inferred["lr"] = lr
    return save_checkpoint(
        out_path,
        {"params": params, "bn": bn, "opt_state": adam_state_to_jax(*adam),
         "mask": mask},
        {"epoch": parse_epoch(path), "cfg": inferred,
         "moments_imported": moments_imported,
         "imported_from": os.path.abspath(path)})


# ---------------------------------------------------------------------------
# Augmenter checkpoints
# ---------------------------------------------------------------------------

def augmenter_from_checkpoint(ckpt: dict):
    """(params, bn, AugmenterConfig) of a reference augmenter checkpoint
    dict (``netA`` state dict + ``parameters``), numpy trees."""
    from dvae_tpu_torch.augment.augmenter import AugmenterConfig

    p = ckpt["parameters"]
    sd = _strip_prefixes(ckpt["netA"])

    def has(ref):
        return f"{ref}.weight" in sd or f"{ref}.weight_orig" in sd

    # the generic Augmenter (udagan.py:16-118) has both a plain fc5 and the
    # noise-concat fc5n; Augmenter_smartseq has one fc5 taking the concat
    generic = has("fc5n")
    lin_map = dict(_AUG_LINEAR)
    bn_map = dict(_AUG_BN)
    if generic:
        lin_map["fc5"] = "fc5n"
        lin_map["fc5_plain"] = "fc5"
        bn_map["bn5"] = "batch_fc5n"
        bn_map["bn5_plain"] = "batch_fc5"
    n_zim = int(p.get("n_zim", 2 if has("fc11_p") else 1))
    # n_dim from the weights where they hold it: the two families'
    # defaults differ (generic 100, smartseq 500)
    if has("fc4"):
        n_dim = int(_np(sd["fc4.weight" if "fc4.weight" in sd
                           else "fc4.weight_orig"]).shape[0])
    else:
        n_dim = int(p.get("n_dim", 500))
    cfg = AugmenterConfig(
        noise_dim=int(p["num_n"]), latent_dim=int(p["num_z"]),
        input_dim=int(p["n_features"]), n_dim=n_dim,
        p_drop=float(p.get("p_drop", 0.2 if generic else 0.5)),
        n_zim=n_zim, variant="generic" if generic else "smartseq")

    params = {}
    for ours, ref in lin_map.items():
        if has(ref):
            w, b = _linear(sd, ref)
            params[ours] = {"w": w.T, "b": b}
    if has("fc11_p"):
        w, b = _linear(sd, "fc11_p")
        params["fc11_p"] = {"w": w.T, "b": b}
    bn = {}
    for ours, ref in bn_map.items():
        if f"{ref}.running_mean" not in sd:
            continue
        st = {"mean": _np(sd[f"{ref}.running_mean"]),
              "var": _np(sd[f"{ref}.running_var"])}
        if f"{ref}.weight" in sd:       # bnz is affine (udagan.py:29)
            st["scale"] = _np(sd[f"{ref}.weight"])
            st["bias"] = _np(sd[f"{ref}.bias"])
        bn[ours] = st
    return params, bn, cfg


def import_augmenter_checkpoint(path: str, out_path: Optional[str] = None,
                                ckpt: Optional[dict] = None) -> str:
    """Convert a reference augmenter ``.pth`` (the ``aug_model`` entry of
    mmidas.toml) into the augmenter checkpoint that ``CplMixVAE(aug_file=…)``
    of either package loads.  Returns the written path."""
    from dvae_tpu_torch.augment.augmenter import save_augmenter

    ckpt = _load_torch(path) if ckpt is None else ckpt
    params, bn, cfg = augmenter_from_checkpoint(ckpt)
    out_path = out_path or os.path.splitext(path)[0] + ".ckpt"
    return save_augmenter(out_path, params, bn, cfg,
                          {"imported_from": os.path.abspath(path)})
