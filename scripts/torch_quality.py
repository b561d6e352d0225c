#!/usr/bin/env python3
"""The port's quality rows on one NVIDIA GPU: the hard-synthetic GAN
augmenter and the mixVAE rows of ROUND5.md, each beside the JAX package's
committed result.

    python3 scripts/torch_quality.py augmenter e1000 aug_port
    python3 scripts/torch_quality.py --epochs 2000 aug_committed

Rows (all on ``hard_synthetic_dataset`` with data_seed 3, drawn on the
card; the port's counts are another draw than the JAX package's, with the
same taxonomy):

  * ``augmenter`` — ``examples.hard_augmenter`` in MSE mode at the
    production cadence (10,000 epochs, batch 5000, bf16, seed 546); its
    checkpoint and curves go to ``--out``; the per-decile means of
    ``mse_recon`` and of the D-skip share are set beside those of
    ``artifacts/hard_synthetic/augmenter_MSE_curves.json``;
  * ``e1000`` — ``examples.hard_synthetic``: MSE, A=2, 1000 epochs, seed 3
    (the JAX row ``r5_mse_a2_e1000``);
  * ``aug_committed`` — the same with the committed JAX-trained
    ``artifacts/hard_synthetic/augmenter_MSE.ckpt`` (up to 25,000 epochs,
    the consensus early stop at 0.75; the JAX row ``r5_mse_a2_aug``);
  * ``aug_port`` — the same with the port's own augmenter of the
    ``augmenter`` row.

``--epochs N`` caps the epochs of every row (the result says so: only a
row that ran its recipe in full is comparable).  Each row writes
``<out>/<row>.json`` with the card's name and power limit as
``nvidia-smi`` reports them, the wall time and, for the mixVAE rows, the
JAX row's AMIs and the gap of the arm-mean leaf AMI.  ``--out`` defaults
to ``artifacts/torch``; the checkpoints there are not committed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _HERE)
JAX_ART = os.path.join(_HERE, "artifacts", "hard_synthetic")
ROWS = ("augmenter", "e1000", "aug_committed", "aug_port")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _jax_json(name: str) -> dict:
    with open(os.path.join(JAX_ART, name)) as fh:
        return json.load(fh)


def augmenter_row(out_dir: str, epochs: int) -> dict:
    from dvae_tpu_torch.examples import hard_augmenter
    ckpt = os.path.join(out_dir, "augmenter_MSE.ckpt")
    res = hard_augmenter.run(mode="MSE", n_epochs=epochs, batch_size=5000,
                             seed=546, data_seed=3, epochs_per_jit=50,
                             out=ckpt)
    res["ckpt"] = os.path.relpath(ckpt, _HERE)
    jax = _jax_json("augmenter_MSE_curves.json")
    # the JAX curve's deciles over the same epochs
    import numpy as np
    jc = jax["curves"]
    j_mse = np.array_split(np.array(jc["mse_recon"][:epochs]), 10)
    j_skip = np.array_split(np.array(jc["d_skipped"][:epochs]), 10)
    res["jax_recon_decile_means"] = [round(float(d.mean()), 5)
                                     for d in j_mse]
    res["jax_d_skip_decile_means"] = [round(float(d.mean()), 4)
                                      for d in j_skip]
    res["jax_n_epochs"] = jax["summary"]["n_epochs"]
    return res


def mixvae_row(row: str, out_dir: str, epochs: int) -> dict:
    from dvae_tpu_torch.examples import hard_synthetic
    aug = {"e1000": "",
           "aug_committed": os.path.join(JAX_ART, "augmenter_MSE.ckpt"),
           "aug_port": os.path.join(out_dir, "augmenter_MSE.ckpt")}[row]
    recipe = 1000 if row == "e1000" else 25000
    jax = _jax_json("r5_mse_a2_e1000.json" if row == "e1000"
                    else "r5_mse_a2_aug.json")
    n_epoch = min(recipe, epochs)
    res = hard_synthetic.run(n_epoch=n_epoch, seed=3, data_seed=3,
                             aug_file=aug, verbose=False)
    if aug:
        res["aug_file"] = os.path.relpath(aug, _HERE)
    res["recipe_epochs"] = recipe
    res["ran_in_full"] = n_epoch == recipe
    res["jax_row"] = {k: jax[k] for k in ("final_epoch", "ami_leaf",
                                          "ami_root", "ami_arm_arm",
                                          "test_consensus", "wall_min")}
    mean = sum(res["ami_leaf"]) / len(res["ami_leaf"])
    jmean = sum(jax["ami_leaf"]) / len(jax["ami_leaf"])
    res["leaf_ami_mean"] = mean
    res["leaf_ami_mean_gap"] = mean - jmean
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rows", nargs="+", choices=ROWS)
    ap.add_argument("--epochs", type=int, default=None,
                    help="cap every row's epochs (default: the recipes')")
    ap.add_argument("--out", default=os.path.join(_HERE, "artifacts",
                                                  "torch"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    for row in args.rows:
        t0 = time.time()
        if row == "augmenter":
            res = augmenter_row(args.out, args.epochs or 10000)
        else:
            res = mixvae_row(row, args.out, args.epochs or 25000)
        res["row"] = row
        res["card"] = card
        res["wall_s"] = time.time() - t0
        with open(os.path.join(args.out, f"{row}.json"), "w") as fh:
            json.dump(res, fh, indent=2)
        print(f"ROW {row}: {json.dumps(res)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
