"""CplMixVAE of the PyTorch port — the serving half.

Counterpart of dvae_tpu/train/cpl_mixvae.py (reference ``cpl_mixVAE``,
mmidas/cpl_mixvae.py:152-1650): ``init_model``, the standalone
``load_model`` that rebuilds the configs from a checkpoint's metadata,
``save_checkpoint``, and the eval surfaces ``_eval_batches``,
``_predict_labels``, ``validate`` and ``eval_model``.  Training, pruning
and the augmenter arrive with later slices.

The model runs on ``device`` (default ``"cuda"``; pass ``"cpu"``
explicitly).  On CUDA in MSE mode the reconstruction loss goes through the
hand-written fused kernel (``ops/recon.py``), as the JAX package turns its
Pallas kernels on by default on a TPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from dvae_tpu_torch.config import (MeshConfig, ShardingStrategy, TrainConfig,
                                   VAEConfig)
from dvae_tpu_torch.eval.metrics import (consensus_device_both,
                                         consensus_from_labels)
from dvae_tpu_torch.models import mixvae
from dvae_tpu_torch.train.step import (TrainState, make_eval_runner,
                                       make_eval_step)
from dvae_tpu_torch.utils.checkpoint import (bn_from_jax, load_checkpoint,
                                             params_from_jax, save_checkpoint)

_EVAL_FLUSH_BYTES = 1 << 30  # eval_model drains device accumulators to
                             # host past this many retained bytes


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def _seed_from_key_data(key_data) -> int:
    """A 63-bit generator seed from a JAX PRNG key's raw words."""
    words = np.asarray(key_data, np.uint32).ravel()
    seed = 0
    for w in words[:2]:
        seed = (seed << 32) | int(w)
    return seed & ((1 << 63) - 1)


def _key_data_from_seed(seed: int) -> np.ndarray:
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


class CplMixVAE:
    """Coupled mixture-VAE: model lifecycle and batched inference."""

    def __init__(self, saving_folder: str = "", device="cuda",
                 seed: int = 546):
        self.folder = saving_folder
        if saving_folder:
            os.makedirs(saving_folder, exist_ok=True)
        self.device = _resolve_device(device)
        self.seed = seed
        self.cfg: Optional[VAEConfig] = None
        self.tcfg: Optional[TrainConfig] = None
        self.state: Optional[TrainState] = None
        self.temp = 1.0
        self._eval_step = None
        self._eval_runner = None

    # -- model lifecycle ----------------------------------------------------

    def _fused_default(self) -> bool:
        return self.device.type == "cuda"

    def init_model(self, n_categories: int = 92, state_dim: int = 2,
                   input_dim: int = 5032, fc_dim: int = 100,
                   lowD_dim: int = 10, lam: float = 1.0, lam_pc: float = 1.0,
                   n_arm: int = 2, temp: float = 1.0, tau: float = 0.005,
                   beta: float = 1.0, variational: bool = True,
                   ref_prior: bool = False, n_pr: int = 0,
                   mode: str = "MSE", batch_size: int = 5000,
                   bf16: bool = False, fused: Optional[bool] = None,
                   **extra) -> None:
        """Build the configs and a freshly initialised state (reference
        ``init_model``, cpl_mixvae.py:193-286), restricted to the fields eval
        reads; ``extra`` passes any other ``VAEConfig`` field.  ``fused``
        enables the fused recon-loss kernel; None turns it on on CUDA."""
        if fused is None:
            fused = self._fused_default()
        extra.setdefault("fused_recon", fused)
        self.cfg = VAEConfig(
            n_categories=n_categories, state_dim=state_dim,
            input_dim=input_dim, fc_dim=fc_dim, lowD_dim=lowD_dim, lam=lam,
            lam_pc=lam_pc, n_arm=n_arm, temp=temp, tau=tau, beta=beta,
            variational=variational, ref_prior=ref_prior, n_pr=n_pr,
            mode=mode, **extra)
        self.tcfg = TrainConfig(batch_size=batch_size, bf16=bf16,
                                seed=self.seed)
        self.temp = temp
        gen = torch.Generator(device="cpu").manual_seed(self.seed)
        params = mixvae.init_params(gen, self.cfg, device=self.device)
        mask = torch.ones(n_categories, device=self.device)
        if n_pr > 0:
            mask[-n_pr:] = 0.0
        self.state = TrainState(
            params=params, bn=mixvae.init_bn_state(self.cfg, self.device),
            mask=mask, seed=self.seed, epoch=0)
        self._reset_eval_fns()

    def _reset_eval_fns(self) -> None:
        self._eval_step = None
        self._eval_runner = None

    def load_model(self, filename: str) -> int:
        """Restore the model state from a checkpoint written by either
        package (reference ``load_model``, cpl_mixvae.py:317).  On a fresh
        instance the configs are rebuilt from the metadata.  Returns the
        stored epoch (or -1)."""
        tree, meta = load_checkpoint(filename)
        if self.cfg is None:
            if not meta.get("cfg"):
                raise ValueError(f"{filename} has no 'cfg' metadata; call "
                                 "init_model first to load a bare checkpoint")
            cfg_d = dict(meta["cfg"])
            tcfg_d = dict(meta.get("tcfg") or {})
            if isinstance(tcfg_d.get("mesh"), dict):
                tcfg_d["mesh"] = MeshConfig(**tcfg_d["mesh"])
            if "sharding" in tcfg_d:
                tcfg_d["sharding"] = ShardingStrategy(tcfg_d["sharding"])
            self.cfg = VAEConfig(**cfg_d)
            self.tcfg = TrainConfig(**tcfg_d)
            self.temp = self.cfg.temp
            if self.cfg.mode == "MSE" and self._fused_default():
                # how the model was trained does not decide how it is
                # served: on CUDA the kernel is the serving path
                self.cfg = self.cfg.replace(fused_recon=True)
        seed = (_seed_from_key_data(tree["key_data"]) if "key_data" in tree
                else self.seed)
        self.state = TrainState(
            params=params_from_jax(tree["params"], self.device),
            bn=bn_from_jax(tree["bn"], self.device),
            mask=torch.from_numpy(np.array(tree["mask"])).to(self.device),
            seed=seed, epoch=int(meta.get("epoch", 0)),
            opt_state=tree.get("opt_state"))
        self._reset_eval_fns()
        return int(meta.get("epoch", -1))

    def save_checkpoint(self, tag: str) -> str:
        """Write the state in the JAX package's checkpoint format."""
        path = os.path.join(self.folder or ".", f"cpl_mixVAE_model_{tag}.ckpt")
        st = self.state
        tree = {"params": st.params, "bn": st.bn, "opt_state": st.opt_state,
                "mask": st.mask, "key_data": _key_data_from_seed(st.seed)}
        meta = {"epoch": int(st.epoch),
                "cfg": dict(self.cfg.__dict__),
                "tcfg": {**dataclasses.asdict(self.tcfg),
                         "sharding": self.tcfg.sharding.value}}
        return save_checkpoint(path, tree, meta)

    # -- evaluation ---------------------------------------------------------

    def _eval_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.tcfg.bf16 else torch.float32

    def _ensure_eval_fns(self) -> None:
        if self.state is None:
            raise RuntimeError("call init_model or load_model first")
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.cfg, self.tcfg)
        if self._eval_runner is None:
            self._eval_runner = make_eval_runner(self.cfg, self.tcfg)

    def _to_device(self, x) -> torch.Tensor:
        """The dataset on the model's device in the eval dtype (no copy
        when it is there already)."""
        return torch.as_tensor(x).to(device=self.device,
                                     dtype=self._eval_dtype())

    def _eval_batches(self, x_all: torch.Tensor, batch_size: int, c_p=None):
        """Yield ``("chunk", x (K, B, D), prior)`` chunks of K ≤ 8 full
        batches for the eval runner, then ``("batch", x (b, D), prior)``
        for the leftovers (dvae_tpu/train/cpl_mixvae.py:788-823)."""
        n = x_all.shape[0]
        prior = (None if c_p is None else
                 torch.as_tensor(np.asarray(c_p), dtype=torch.float32)
                 .to(self.device))
        i = 0
        K = min(8, n // batch_size)
        if K >= 2:
            while n - i >= K * batch_size:
                chunk = x_all[i: i + K * batch_size].reshape(
                    K, batch_size, *x_all.shape[1:])
                pc = (None if prior is None else
                      prior[i: i + K * batch_size].reshape(K, batch_size, -1))
                yield "chunk", chunk, pc
                i += K * batch_size
        for i in range(i, n, batch_size):
            pb = None if prior is None else prior[i: i + batch_size]
            yield "batch", x_all[i: i + batch_size], pb

    def _predict_labels(self, x_all, temp, batch_size: int = 5000):
        """Eval-mode argmax labels over a dataset → (A, N) numpy."""
        self._ensure_eval_fns()
        x_all = self._to_device(x_all)
        outs = []
        for kind, xb, _ in self._eval_batches(x_all, batch_size):
            if kind == "chunk":
                _, f = self._eval_runner(self.state, xb, temp)
                outs.append(f.lab)
            else:
                _, labels, _ = self._eval_step(self.state, xb, None, temp)
                outs.append(labels)
        return torch.cat(outs, dim=1).cpu().numpy()

    def validate(self, x_val, temp: float = 1.0, batch_size: int = 5000,
                 c_p=None) -> dict:
        """Validation losses + consensus (reference val loop,
        cpl_mixvae.py:563-761)."""
        self._ensure_eval_fns()
        x = self._to_device(x_val)
        tot, recs, labels, sizes = [], [], [], []
        for kind, xb, pb in self._eval_batches(x, batch_size, c_p):
            if kind == "chunk":
                aux, f = self._eval_runner(self.state, xb, temp, pb)
                tot.append(aux.total)
                recs.append(aux.loss_rec)
                labels.append(f.lab)
                sizes.extend([batch_size] * xb.shape[0])
            else:
                aux, lab, _ = self._eval_step(self.state, xb, pb, temp)
                tot.append(aux.total[None])
                recs.append(aux.loss_rec[None])
                labels.append(lab)
                sizes.append(xb.shape[0])
        tot = torch.cat(tot).cpu().numpy()
        recs = torch.cat(recs, dim=0).cpu().numpy()
        cons, cons_active = (float(v) for v in consensus_device_both(
            torch.cat(labels, dim=1), self.cfg.n_categories))
        rec = np.average(recs, axis=0, weights=sizes)
        return {"loss": float(np.average(tot, weights=sizes)),
                "consensus": cons,
                "consensus_active": cons_active,
                **{f"rec_loss_arm{a}": float(rec[a])
                   for a in range(self.cfg.n_arm)}}

    def eval_model(self, x, temp: float = 1.0, batch_size: int = 5000,
                   c_p=None) -> dict:
        """Batched no-grad inference over a dataset (reference
        ``eval_model``, cpl_mixvae.py:1450-1619).  ``x``: (N, D) numpy
        array or tensor; a tensor already on the device in the eval dtype
        is used in place.

        Returns per-arm ``c_prob`` (A,N,C), ``state_mu``/``state_logvar``
        (A,N,S), ``x_low`` (A,N,L), ``pred_label`` (A,N), the batch-size
        weighted ``total_loss`` and ``total_loss_rec`` (A,), the consensus
        over arms and the category ``mask`` — all numpy.
        """
        self._ensure_eval_fns()
        xd = self._to_device(x)
        keys = ("c", "s_mean", "s_logvar", "x_low", "lab")
        fields = {k: {"dev": [], "host": []} for k in keys}
        recs, totals, sizes = [], [], []
        pending = 0

        def drain_field(d):
            if d["dev"]:
                t = torch.cat(d["dev"], dim=1)
                if t.dtype == torch.bfloat16:  # no numpy dtype: leave as f32
                    t = t.float()
                d["host"].append(t.cpu().numpy())
                d["dev"].clear()

        for kind, xb, pb in self._eval_batches(xd, batch_size, c_p):
            if kind == "chunk":
                aux, f = self._eval_runner(self.state, xb, temp, pb)
                vals = f._asdict()
                recs.append(aux.loss_rec)
                totals.append(aux.total)
                sizes.extend([batch_size] * xb.shape[0])
            else:
                aux, lab, outs = self._eval_step(self.state, xb, pb, temp)
                vals = {"c": outs.c, "s_mean": outs.s_mean,
                        "s_logvar": outs.s_logvar, "x_low": outs.x_low,
                        "lab": lab}
                recs.append(aux.loss_rec[None])
                totals.append(aux.total[None])
                sizes.append(xb.shape[0])
            for k in keys:
                fields[k]["dev"].append(vals[k])
                pending += vals[k].numel() * vals[k].element_size()
            if pending >= _EVAL_FLUSH_BYTES:
                for d in fields.values():
                    drain_field(d)
                pending = 0

        def flush(key):
            d = fields[key]
            drain_field(d)
            parts = d["host"]
            return parts[0] if len(parts) == 1 else np.concatenate(parts,
                                                                   axis=1)

        labels = flush("lab")
        w = np.asarray(sizes, np.float64)
        totals = torch.cat(totals).cpu().numpy()
        recs = torch.cat(recs, dim=0).cpu().numpy()
        return {
            "c_prob": flush("c"),
            "state_mu": flush("s_mean"),
            "state_logvar": flush("s_logvar"),
            "x_low": flush("x_low"),
            "pred_label": labels,
            "total_loss": float(np.average(totals, weights=w)),
            "total_loss_rec": np.average(recs, axis=0, weights=w),
            "consensus": consensus_from_labels(labels, self.cfg.n_categories),
            "mask": self.state.mask.cpu().numpy(),
        }
