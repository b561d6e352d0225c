"""Continuous-state traversal study of the PyTorch port.

Counterpart of dvae_tpu/examples/state_traversal.py (reference
``mixVAE_model.state_changes``, mmidas/nn_model.py:370-411): hold each
cell's category fixed, resample one continuous state dimension from its
posterior, and rank the genes by how their reconstruction follows it.

Run: ``python -m dvae_tpu_torch.examples.state_traversal --ckpt <path>``
(a checkpoint of either package, loaded by ``models.api.load_vae``; without
one a freshly initialised model on synthetic data) with ``--device cpu``
where there is no card.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from dvae_tpu_torch.analysis.tree_based import corr_analysis
from dvae_tpu_torch.config import VAEConfig
from dvae_tpu_torch.models import mixvae


def traversal_study(cfg: VAEConfig, params, bn, x, d_s: int = 0,
                    n_samp: int = 50,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None,
                    draws: Optional[torch.Tensor] = None) -> dict:
    """Sweep state dimension ``d_s`` (``mixvae.state_changes`` on the
    device of ``params``; ``generator`` defaults to a CPU one seeded 0,
    ``noise``/``draws`` as there) and correlate arm 0's reconstructions
    with the swept values.  Returns 'recon' (A, n_samp, B, D), 's_vals'
    (A, n_samp, B), 'gene_corr_sorted' (the genes' |r|, ascending) and
    'gene_order' (their indices in that order)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dev = params["fc1"]["w"].device
    xd = torch.as_tensor(x).to(dev, torch.float32)
    recon, s_vals = mixvae.state_changes(params, bn, cfg, xd, d_s=d_s,
                                         n_samp=n_samp, generator=generator,
                                         noise=noise, draws=draws)
    recon = recon.cpu().numpy()
    s_vals = s_vals.cpu().numpy()
    B = xd.shape[0]
    corr, gene_order = corr_analysis(s_vals[0].reshape(n_samp * B, 1),
                                     recon[0].reshape(n_samp * B, -1))
    return {"recon": recon, "s_vals": s_vals,
            "gene_corr_sorted": corr[0], "gene_order": gene_order[0]}


def main(argv=None) -> int:
    from dvae_tpu_torch.data.anndata_io import synthetic_dataset
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--d_s", type=int, default=0)
    ap.add_argument("--n_samp", type=int, default=50)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if args.ckpt:
        from dvae_tpu_torch.models.api import load_vae
        cfg, params, bn, _ = load_vae(args.ckpt, device=args.device)
        x = synthetic_dataset(64, cfg.input_dim,
                              min(cfg.n_categories, 10)).log1p
    else:
        from dvae_tpu_torch.train.cpl_mixvae import _resolve_device
        dev = _resolve_device(args.device)
        cfg = VAEConfig(n_categories=10, input_dim=100, fc_dim=16,
                        lowD_dim=8, n_arm=2, tau=0.1)
        params = mixvae.init_params(torch.Generator().manual_seed(0), cfg,
                                    device=dev)
        bn = mixvae.init_bn_state(cfg, device=dev)
        x = synthetic_dataset(64, 100, 10).log1p

    out = traversal_study(cfg, params, bn, x, d_s=args.d_s,
                          n_samp=args.n_samp)
    top = out["gene_order"][-10:][::-1]
    print(f"state dim {args.d_s}: top responding genes {top.tolist()}")
    print(f"max |corr| {out['gene_corr_sorted'][-1]:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
