"""Command-line entry points of the PyTorch port: ``train``, ``evaluate``
and ``train-augmenter``.

Counterparts of ``dvae_tpu.cli train``, ``evaluate`` and
``train-augmenter`` (dvae_tpu/cli.py:92-164, :185-236; reference
train.py:172-267, evaluation.py:92-127, dist/train_agumenter.py):

    python -m dvae_tpu_torch.cli train --n_arm 2 --n_epoch 1000 ...
    python -m dvae_tpu_torch.cli evaluate --ckpt model.ckpt --synthetic
    python -m dvae_tpu_torch.cli train-augmenter --n_epoch 50 --out aug.ckpt

``train`` trains in an auto-numbered ``{saving_folder}K…_RUN{n}`` folder
and, with ``--resume``, continues the newest such folder from its latest
checkpoint.  ``evaluate`` loads a checkpoint written by either package,
runs batched inference over the dataset, and prints the consensus and
adjusted-MI metrics as one JSON line (also saved to
``evaluation/A{n}-RUN{run}-E{epoch}.npy``).  The model runs on
``--device`` (default ``cuda``).  ``train --loss_mode ZINB`` trains the
zero-inflated negative-binomial reconstruction (``evaluate`` takes the
mode from the checkpoint); ``train --align_every N`` Hungarian-aligns the
arms' category indices every N epochs; ``train --aug_file PATH`` trains
every arm on its own view from a frozen augmenter; ``train --stream``
keeps the training set on the host and streams batches to the device.
The dataset is the ``.h5ad`` file that ``--toml`` (default ``dvae.toml``)
names in the section ``--dataset`` (its ``data_path`` and
``anndata_file``), cut to the first ``--n_gene`` genes; where that file is
absent, or with ``--synthetic``, a synthetic one
(``--syn_cells``/``--syn_genes``/``--syn_types``): planted Gaussian
programs, or with ``--syn_hard`` (alias ``--hard_synthetic``) ZINB counts
with library-size variation, dropout and overlapping types.  The parsers
accept every option of the JAX package's; the options of features still to
port (``--sharding``/``--mesh_*``/``--coordinator``/``--num_processes``/
``--process_id``, ``--wandb``) raise the trainer's ``NotImplementedError``.
``--rng_impl`` is kept in the checkpoint's metadata: the port draws from
``torch.Generator`` whatever it names.  ``train-augmenter`` trains the
VAE-GAN augmenter (``augment/train.py``) on the same datasets and writes a
checkpoint that ``train --aug_file`` (of either package) loads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _load_dataset(args):
    """The TOML-resolved .h5ad when it exists, else synthetic
    (dvae_tpu/cli.py:69-89)."""
    from dvae_tpu_torch.data.anndata_io import (hard_synthetic_dataset,
                                                load_data, synthetic_dataset)
    from dvae_tpu_torch.utils.tools import get_paths
    if args.syn_hard:
        print("using HARD synthetic dataset (ZINB counts)")
        return hard_synthetic_dataset(
            n_cells=args.syn_cells, n_genes=args.syn_genes,
            n_types=args.syn_types, seed=args.seed)
    if not args.synthetic and os.path.exists(args.toml):
        config = get_paths(toml_file=args.toml, sub_file=args.dataset)
        sec = config.get(args.dataset, {})
        f = (config["paths"]["main_dir"] / str(sec.get("data_path", ""))
             / str(sec.get("anndata_file", "")))
        if sec.get("anndata_file") and f.is_file():
            return load_data(str(f), n_gene=args.n_gene)
    print("using synthetic dataset")
    return synthetic_dataset(n_cells=args.syn_cells, n_genes=args.syn_genes,
                             n_types=args.syn_types, seed=args.seed)


def cmd_train(args) -> int:
    from dvae_tpu_torch.data.pipeline import stratified_split_indices
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    from dvae_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                 latest_run_dir,
                                                 make_run_dir,
                                                 newest_checkpoint)

    ds = _load_dataset(args)
    prefix = (f"K{args.n_categories}_S{args.state_dim}"
              f"_AUG{bool(args.aug_file)}"
              f"_LR{args.lr}_A{args.n_arm}_B{args.batch_size}"
              f"_E{args.n_epoch}_Ep{args.n_epoch_p}")
    base = args.saving_folder or "results/"
    folder = latest_run_dir(base, prefix) if args.resume else None
    if args.resume and folder is None:
        print("--resume: no existing run folder; starting fresh")
    folder = folder or make_run_dir(base, prefix)
    print(f"run folder: {folder}")

    tr, te = stratified_split_indices(ds.cluster_label, 0.9, args.seed)
    cpl = CplMixVAE(saving_folder=folder, aug_file=args.aug_file,
                    seed=args.seed, device=args.device)
    cpl.init_model(
        n_categories=args.n_categories, state_dim=args.state_dim,
        input_dim=ds.log1p.shape[1], fc_dim=args.fc_dim,
        lowD_dim=args.latent_dim, x_drop=args.p_drop, s_drop=args.s_drop,
        lr=args.lr, lam=args.lam, lam_pc=args.lam_pc, n_arm=args.n_arm,
        temp=args.temp, tau=args.tau, beta=args.beta, hard=args.hard,
        ref_prior=args.ref_pc, trained_model=args.pretrained_model,
        variational=args.variational, n_pr=args.n_pr,
        mode=args.loss_mode, batch_size=args.batch_size,
        epochs_per_jit=args.epochs_per_jit, bf16=args.bf16,
        optimizer=args.optimizer, rng_impl=args.rng_impl,
        fused={"auto": None, "on": True, "off": False}[args.fused],
        shuffle_block=args.shuffle_block, stream=args.stream,
        ckpt_every=args.ckpt_every,
        eval_every=args.eval_every, align_arms_every=args.align_every,
        local_bn_stats=args.local_bn_stats)
    done = 0
    if args.resume:
        ckpt = latest_checkpoint(folder) or newest_checkpoint(folder)
        if ckpt:
            epoch = cpl.load_model(ckpt)
            done = int(cpl.resume_progress.get("main_epochs", epoch))
            print(f"resumed from {ckpt} (epoch {epoch}, main epochs done "
                  f"{done})")
    path = cpl.train(ds.log1p[tr], x_val=ds.log1p[te],
                     n_epoch=max(args.n_epoch - done, 0),
                     n_epoch_p=args.n_epoch_p, c_p=ds.c_p, train_idx=tr,
                     val_idx=te, min_con=args.min_con,
                     max_prun_it=args.max_prun_it, temp=args.temp)
    print(f"final checkpoint: {path}")
    return 0


def cmd_evaluate(args) -> int:
    from dvae_tpu_torch.eval.evaluate import (avg_consensus, avg_max,
                                              mutinfo, summarize_inference)
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    from dvae_tpu_torch.utils.checkpoint import latest_checkpoint

    ckpt = args.ckpt or latest_checkpoint(args.saving_folder or ".")
    if not ckpt:
        print("no checkpoint found", file=sys.stderr)
        return 1
    ds = _load_dataset(args)
    # a fresh instance: load_model rebuilds cfg/tcfg from the metadata
    cpl = CplMixVAE(saving_folder=args.saving_folder or ".",
                    device=args.device)
    preds = summarize_inference(cpl, ckpt, ds.log1p)
    n_arm = preds["pred_label"].shape[0]
    if n_arm != args.n_arm:
        print(f"note: checkpoint has {n_arm} arms (flag said {args.n_arm})")
    mis = [avg_max(mutinfo(preds["c_prob"][a], ds.c_onehot.astype(int)))
           for a in range(n_arm)]
    consensus = avg_consensus(preds["pred_label"])
    res = {"pairwise": consensus["pairwise"], "all": consensus["all"],
           "mi": mis, "avg_mi": float(np.mean(mis)), "arms": n_arm,
           "consensus": preds["consensus"]}
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir,
                         f"A{n_arm}-RUN{args.run}-E{args.n_epoch}.npy"), res)
    print(json.dumps(res, default=float))
    return 0


def cmd_train_augmenter(args) -> int:
    from dvae_tpu_torch.augment.augmenter import AugmenterConfig
    from dvae_tpu_torch.augment.train import train_augmenter

    ds = _load_dataset(args)
    cfg = AugmenterConfig(noise_dim=args.noise_dim, latent_dim=args.z_dim,
                          input_dim=ds.n_genes, n_dim=args.n_dim,
                          p_drop=args.p_drop)
    out = args.out or (f"trained_augmenter_bs_{args.batch_size}"
                       f"_dn_{args.noise_dim}_dz_{args.z_dim}"
                       f"_l1_{args.lambda_[0]}_l2_{args.lambda_[1]}"
                       f"_l3_{args.lambda_[2]}_l4_{args.lambda_[3]}.ckpt")
    train_augmenter(ds.log1p, cfg, n_epochs=args.n_epoch,
                    batch_size=args.batch_size, lr=args.lr,
                    lambdas=tuple(args.lambda_), alpha=args.alpha,
                    mode=args.mode, seed=args.seed, saving_path=out,
                    bf16=args.gan_bf16, device=args.device)
    print(f"saved augmenter: {out}")
    return 0


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    """The reference's mixVAE hyperparameters (dvae_tpu/cli.py:28-49)."""
    for flag, typ, default in (
            ("--n_categories", int, 92), ("--state_dim", int, 2),
            ("--n_arm", int, 2), ("--temp", float, 1.0),
            ("--tau", float, 0.005), ("--beta", float, 1.0),
            ("--lam", float, 1.0), ("--lam_pc", float, 1.0),
            ("--latent_dim", int, 10), ("--fc_dim", int, 100),
            ("--p_drop", float, 0.5), ("--s_drop", float, 0.2),
            ("--lr", float, 1e-3)):
        p.add_argument(flag, type=typ, default=default)
    p.add_argument("--hard", action="store_true")
    # type=bool as in the reference: any non-empty value is True
    p.add_argument("--variational", type=bool, default=True)
    p.add_argument("--ref_pc", action="store_true",
                   help="couple to the reference prior (ref_prior mode)")
    p.add_argument("--loss_mode", type=str, default="MSE",
                   choices=["MSE", "ZINB"])
    p.add_argument("--pretrained_model", type=str, default=None)
    p.add_argument("--n_pr", type=int, default=0)


def _add_data_flags(p: argparse.ArgumentParser) -> None:
    """The reference's dataset flags (dvae_tpu/cli.py:52-66)."""
    p.add_argument("--toml", type=str, default="dvae.toml",
                   help="dataset TOML: per-dataset data_path/anndata_file")
    p.add_argument("--dataset", type=str, default="mouse_smartseq",
                   help="the TOML section of the dataset")
    p.add_argument("--n_gene", type=int, default=0,
                   help="keep the first n genes (0: all)")
    p.add_argument("--synthetic", action="store_true",
                   help="force synthetic data")
    p.add_argument("--syn_hard", "--hard_synthetic", action="store_true",
                   help="the hard-mode ZINB-count synthetic generator "
                        "(library-size variation, dropout, hierarchically "
                        "overlapping types) instead of the planted-"
                        "Gaussian one")
    p.add_argument("--syn_cells", type=int, default=5000)
    p.add_argument("--syn_genes", type=int, default=500)
    p.add_argument("--syn_types", type=int, default=20)


def _refuse_unported(args) -> None:
    """Raise the trainer's NotImplementedError for a flag whose feature
    arrives with a later slice of the port."""
    from dvae_tpu_torch.train.cpl_mixvae import _not_ported
    if getattr(args, "sharding", "no") != "no":
        raise _not_ported(f"--sharding {args.sharding}", "multi-GPU")
    for flag in ("mesh_data", "mesh_arm", "mesh_fsdp"):
        if getattr(args, flag, 1) != 1:
            raise _not_ported("a mesh of several devices", "multi-GPU")
    for flag in ("coordinator", "num_processes", "process_id"):
        if getattr(args, flag, None) is not None:
            raise _not_ported(f"several processes (--{flag})", "multi-GPU")
    if getattr(args, "wandb", False):
        raise _not_ported("wandb logging (--wandb)", "logging")


def build_parser() -> argparse.ArgumentParser:
    """The ``train``, ``evaluate`` and ``train-augmenter`` parsers: every
    option of the JAX package's (dvae_tpu/cli.py:256-353) and the port's own
    ``--device``, ``--aug_file`` and ``--out_dir``."""
    parser = argparse.ArgumentParser(prog="dvae_tpu_torch",
                                     description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train a coupled mixVAE")
    _add_model_flags(pt)
    _add_data_flags(pt)
    for flag, typ, default in (
            ("--n_epoch", int, 50000), ("--n_epoch_p", int, 0),
            ("--max_prun_it", int, 0), ("--min_con", float, 0.99),
            ("--batch_size", int, 5000), ("--epochs_per_jit", int, 10),
            ("--ckpt_every", int, 10), ("--eval_every", int, 10),
            ("--shuffle_block", int, 1), ("--align_every", int, 0),
            ("--seed", int, 546), ("--mesh_data", int, 1),
            ("--mesh_arm", int, 1), ("--mesh_fsdp", int, 1),
            ("--num_processes", int, None), ("--process_id", int, None)):
        pt.add_argument(flag, type=typ, default=default)
    pt.add_argument("--rng_impl", type=str, default="threefry2x32",
                    choices=["threefry2x32", "rbg"],
                    help="kept in the checkpoint's metadata; the port "
                         "draws from torch.Generator whatever it names")
    pt.add_argument("--aug_file", type=str, default=None,
                    help="checkpoint of a frozen augmenter: every arm "
                         "trains on its own noisy view of each batch")
    pt.add_argument("--saving_folder", type=str, default="")
    pt.add_argument("--optimizer", type=str, default="adam",
                    choices=["adam", "adamw"])
    pt.add_argument("--sharding", type=str, default="no",
                    choices=["full", "grad-op", "no", "hybrid",
                             "hybrid-zero2", "ddp"])
    pt.add_argument("--coordinator", type=str, default=None)
    pt.add_argument("--bf16", action="store_true")
    pt.add_argument("--fused", type=str, default="auto",
                    choices=["auto", "on", "off"],
                    help="hand-written kernels (auto: on for cuda)")
    pt.add_argument("--resume", action="store_true",
                    help="continue the newest matching _RUN{n} folder from "
                         "its latest checkpoint")
    pt.add_argument("--stream", action="store_true",
                    help="keep the dataset on the host and stream batches "
                         "to the device (for datasets larger than its "
                         "memory; data/stream.py)")
    pt.add_argument("--local_bn_stats", action="store_true",
                    help="per-group (ghost) batch-norm statistics over the "
                         "mesh's data blocks (one group on one device)")
    pt.add_argument("--wandb", action="store_true",
                    help="not ported yet: refused")
    pt.add_argument("--device", type=str, default="cuda",
                    help="torch device of the model (cuda or cpu)")
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser("evaluate", help="consensus + adjusted-MI metrics")
    _add_model_flags(pe)
    _add_data_flags(pe)
    pe.add_argument("--ckpt", type=str, default=None)
    pe.add_argument("--saving_folder", type=str, default="")
    # accepted as the reference accepts it: the checkpoint's batch size
    # serves, as in dvae_tpu.cli evaluate
    pe.add_argument("--batch_size", type=int, default=5000)
    pe.add_argument("--run", type=int, default=0)
    pe.add_argument("--n_epoch", type=int, default=0)
    pe.add_argument("--seed", type=int, default=546)
    pe.add_argument("--out_dir", type=str, default="evaluation")
    pe.add_argument("--device", type=str, default="cuda",
                    help="torch device of the model (cuda or cpu)")
    pe.set_defaults(fn=cmd_evaluate)

    pa = sub.add_parser("train-augmenter", help="train the VAE-GAN augmenter")
    _add_data_flags(pa)
    for flag, typ, default in (
            ("--n_epoch", int, 50), ("--batch_size", int, 1000),
            ("--noise_dim", int, 50), ("--z_dim", int, 10),
            ("--n_dim", int, 500), ("--p_drop", float, 0.5),
            ("--lr", float, 1e-3), ("--alpha", float, 0.2),
            ("--out", str, None), ("--seed", int, 546)):
        pa.add_argument(flag, type=typ, default=default)
    pa.add_argument("--lambda", dest="lambda_", type=float, nargs=4,
                    default=[1.0, 0.5, 0.1, 0.5])
    pa.add_argument("--mode", type=str, default="MSE",
                    choices=["MSE", "ZINB"])
    pa.add_argument("--gan_bf16", action="store_true",
                    help="mixed-precision GAN step (bf16 products, f32 "
                         "losses and master weights)")
    pa.add_argument("--device", type=str, default="cuda",
                    help="torch device of the GAN (cuda or cpu)")
    pa.set_defaults(fn=cmd_train_augmenter)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
