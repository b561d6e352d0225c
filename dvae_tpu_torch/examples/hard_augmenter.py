"""Train the VAE-GAN augmenter on the hard-synthetic data, in the port.

Counterpart of dvae_tpu/examples/hard_augmenter.py: the pretrained frozen
augmenter that the reference's production path loads (train.py:97-113;
applied every batch, cpl_mixvae.py:422-425), trained by
``augment/train.train_augmenter`` (gated discriminator updates at the
log(2)/2 threshold, λ = [1, .5, .1, .5]) at the reference's production
cadence (n_epoch 10000, batch 5000, latent 10, noise 50;
dist/train_agumenter.py:13-20) on the hard-synthetic training split.  It
writes:

  * the checkpoint, with weights rounded to bf16 (the production loop
    consumes them in bf16) and stored as f32: the port writes no
    ``ml_dtypes`` arrays, and either package reads the file;
  * beside it, ``<name>_curves.json``: the per-epoch A/D/gen/recon/triplet
    losses and the D-skip share (the reference's ``n_adv`` diagnostic) and
    a summary with per-decile means.

The default output is ``artifacts/torch/augmenter_{mode}.ckpt``: a port run
never writes over the JAX package's ``artifacts/hard_synthetic/``.

Run: ``python -m dvae_tpu_torch.examples.hard_augmenter [--mode MSE|ZINB
--epochs 10000 --device cuda]``; then
``python -m dvae_tpu_torch.examples.hard_synthetic --aug_file <ckpt>``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

_ART = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "artifacts", "torch")


def run(mode: str = "MSE", n_epochs: int = 10000, batch_size: int = 5000,
        seed: int = 546, data_seed: int = 3, epochs_per_jit: int = 50,
        out: str = "", verbose: bool = False, device="cuda") -> dict:
    import numpy as np
    import torch

    from dvae_tpu_torch.augment.augmenter import save_augmenter
    from dvae_tpu_torch.augment.train import train_augmenter
    from dvae_tpu_torch.data.pipeline import stratified_split_indices
    from dvae_tpu_torch.examples.hard_synthetic import _dataset

    t0 = time.time()
    ds = _dataset(data_seed, device)
    tr, _ = stratified_split_indices(ds.cluster_label, 0.9, data_seed)
    x = ds.log1p[tr]

    params, bn, a_cfg, hist = train_augmenter(
        x, n_epochs=n_epochs, batch_size=batch_size, mode=mode, seed=seed,
        bf16=True, epochs_per_jit=epochs_per_jit, verbose=verbose,
        device=device)

    out = out or os.path.join(_ART, f"augmenter_{mode}.ckpt")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    params16 = {n: {k: None if v is None else v.to(torch.bfloat16).float()
                    for k, v in layer.items()} for n, layer in params.items()}
    save_augmenter(out, params16, bn, a_cfg,
                   extra={"mode": mode, "n_epochs": n_epochs,
                          "batch_size": batch_size, "seed": seed,
                          "data_seed": data_seed,
                          "history_tail": hist[-5:]})

    keys = list(hist[0])
    curves = {k: [round(h[k], 5) for h in hist] for k in keys}
    deciles = np.array_split(np.array(hist, dtype=object), 10)
    summary = {
        "ckpt": out,
        "mode": mode,
        "n_epochs": n_epochs,
        "batch_size": batch_size,
        "seed": seed,
        "data_seed": data_seed,
        "wall_min": round((time.time() - t0) / 60, 1),
        "first_epoch": {k: round(hist[0][k], 4) for k in keys},
        "last_epoch": {k: round(hist[-1][k], 4) for k in keys},
        # convergence: per-decile means of the differentiable recon term
        # and of the D-skip share (toward 1: D no longer separates real
        # from augmented)
        "recon_decile_means": [
            round(float(np.mean([h["mse_recon"] for h in dec])), 5)
            for dec in deciles],
        "d_skip_decile_means": [
            round(float(np.mean([h["d_skipped"] for h in dec])), 4)
            for dec in deciles],
    }
    curve_path = os.path.splitext(out)[0] + "_curves.json"
    with open(curve_path, "w") as fh:
        json.dump({"summary": summary, "curves": curves}, fh)
    print(json.dumps(summary, indent=2))
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="MSE", choices=["MSE", "ZINB"])
    ap.add_argument("--epochs", type=int, default=10000)
    ap.add_argument("--batch_size", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=546)
    ap.add_argument("--data_seed", type=int, default=3)
    ap.add_argument("--epochs_per_jit", type=int, default=50)
    ap.add_argument("--out", default="")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    return run(mode=args.mode, n_epochs=args.epochs,
               batch_size=args.batch_size, seed=args.seed,
               data_seed=args.data_seed, epochs_per_jit=args.epochs_per_jit,
               out=args.out, verbose=args.verbose, device=args.device)


if __name__ == "__main__":
    main()
