"""CplMixVAE of the PyTorch port: model lifecycle, training and serving.

Counterpart of dvae_tpu/train/cpl_mixvae.py (reference ``cpl_mixVAE``,
mmidas/cpl_mixvae.py:152-1650): ``init_model``, ``load_model`` (a fresh
instance rebuilds the configs from a checkpoint's metadata),
``save_checkpoint``, ``train`` with its phases (the chunked epoch loop,
validation, checkpoint cadence, the consensus early stop, the NaN halt,
the pruning loop, SIGTERM-safe stops and resume), and the eval surfaces
``_eval_batches``, ``_predict_labels``, ``validate`` and ``eval_model``.

The model runs on ``device`` (default ``"cuda"``; pass ``"cpu"``
explicitly).  On CUDA the hand-written kernels are on by default, as the
JAX package turns its Pallas kernels on on a TPU: the fused dropout+fc1
forward and backward (``ops/encoder.py``) and the fused reconstruction
loss forward+backward (``ops/recon.py`` in MSE mode, ``ops/zinb.py`` in
ZINB mode) in training, the loss's value-only forward in eval.  Under the
fused ZINB kernel ``ll`` is NaN by design (no reconstruction exists to
take it from); the NaN halt looks at the total loss only.  ``use_pallas``
(opt-in, as in the JAX package) adds the fused Gumbel-softmax sampler,
forward and backward, in training (``ops/gumbel.py``) and the fused
coupling distance in every loss (``ops/coupling.py``).
``align_arms_every`` > 0 Hungarian-aligns the arms' category indices every
that many epochs (``train/alignment.py``).  ``fused_decoder`` (opt-in, MSE
mode) runs the whole decoder, trunk and output layer, forward and
backward, in the kernels of ``ops/decoder.py`` instead of the
reconstruction-loss ones.  ``aug_file`` loads a frozen augmenter
(``augment/augmenter.py``): every arm then trains on, and is evaluated
on, its own noisy view of each batch, made on the device inside the chunk.

``save_plots`` (the default, as in the JAX package) writes the loss curve
and every arm pair's consensus matrix into the run folder at the end of
training (``utils/plots.py``).

``stream`` keeps the training set on the host and streams each batch to
the device (``data/stream.py``); the trainer switches to it by itself when
the dataset would take more than 0.7 of the card's memory, as the JAX
package does.  A scipy sparse matrix becomes CSR once and stays on the
host.  The eval surfaces take a host matrix too: a CSR matrix, or a dense
one that would not fit the card, stays on the host and goes to the device
one batch at a time, densified in the eval dtype.

``use_wandb`` forwards the training metrics to wandb when it imports;
without it the logger prints one line and logs locally, as the JAX
package's does.  ``append`` builds further models beside the trainer's own
(``self.models``); ``save_file``/``load_file`` pickle named arrays.

``mesh`` (a ``MeshConfig`` of several devices) trains and serves on a world
of one process per device (``parallel/``; its model is in
parallel/sharding.py): every process builds the same ``CplMixVAE`` after
``parallel.runtime.initialize_distributed``, keeps its blocks of the state
under ``sharding``, and computes on its arms and rows of every batch.  The
metrics, the consensus and ``eval_model``'s arrays are the whole run's on
every rank.  Rank 0 writes the checkpoints, from gathered leaves, in the
one-device format; ``load_model`` on a mesh places the blocks, and a
checkpoint whose mesh exceeds the world loads onto one device.  Every
rank must call every method, in the same order: the collectives inside
them are matched across ranks.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import signal
import time
from typing import Optional

import numpy as np
import torch

from dvae_tpu_torch.config import (MeshConfig, ShardingStrategy, TrainConfig,
                                   VAEConfig)
from dvae_tpu_torch.data.stream import make_streaming_runner
from dvae_tpu_torch.eval.metrics import (consensus_device_both,
                                         consensus_from_labels,
                                         per_category_agreement)
from dvae_tpu_torch.train.alignment import align_state, moved_counts
from dvae_tpu_torch.train.step import (AdamState, TrainState,
                                       init_train_state, make_epoch_runner,
                                       make_eval_runner, make_eval_step,
                                       make_optimizer)
from dvae_tpu_torch.utils.checkpoint import (adam_state_from_jax,
                                             adam_state_to_jax, bn_from_jax,
                                             latest_checkpoint,
                                             load_checkpoint,
                                             newest_checkpoint,
                                             params_from_jax, save_checkpoint)
from dvae_tpu_torch.parallel.runtime import barrier, process_info, rank_device
from dvae_tpu_torch.parallel.sharding import (gather_state, make_mesh,
                                              place_state, put_dataset,
                                              state_specs)
from dvae_tpu_torch.utils.device import resolve_device
from dvae_tpu_torch.utils.host_ops import as_host_tensor
from dvae_tpu_torch.utils.logging import (MetricLogger, device_memory_mb,
                                          mprint)
from dvae_tpu_torch.utils.profiling import span, spanned

_EVAL_FLUSH_BYTES = 1 << 30  # eval_model drains device accumulators to
                             # host past this many retained bytes
_DEVICE_DATASET_FRACTION = 0.7  # a resident dataset above this share of
                                # the card's memory needs streaming


def _dataset_exceeds_device(x, store_dtype: torch.dtype, device) -> bool:
    """True when ``x`` in ``store_dtype`` would take more than
    ``_DEVICE_DATASET_FRACTION`` of the card's memory
    (dvae_tpu/train/cpl_mixvae.py:108-130).  The shape product counts, not
    ``.size``: a scipy sparse matrix lands on the device dense.  Never on
    the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return False
    nbytes = int(np.prod(x.shape)) * torch.empty(
        (), dtype=store_dtype).element_size()
    total = torch.cuda.get_device_properties(dev).total_memory
    return nbytes > _DEVICE_DATASET_FRACTION * total


def _host_matrix(x, dtype: torch.dtype):
    """The streamed training set on the host: CSR for a sparse matrix
    (converted once at ingestion, since the label passes slice it too), else
    a CPU tensor in the storage dtype, cast once (no copy for f32 numpy)."""
    if hasattr(x, "toarray"):
        return x.tocsr()
    if isinstance(x, torch.Tensor):
        return x.to(device="cpu", dtype=dtype)
    return as_host_tensor(np.asarray(x, np.float32)).to(dtype)


def _seed_from_key_data(key_data) -> int:
    """A 63-bit generator seed from a JAX PRNG key's raw words."""
    words = np.asarray(key_data, np.uint32).ravel()
    seed = 0
    for w in words[:2]:
        seed = (seed << 32) | int(w)
    return seed & ((1 << 63) - 1)


def _key_data_from_seed(seed: int) -> np.ndarray:
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


class PreemptionGuard:
    """Trap SIGTERM, let the running chunk finish, checkpoint and stop
    (dvae_tpu/train/cpl_mixvae.py:62-105).  ``_run_phase`` polls
    ``tripped`` at every chunk boundary.  No-op outside the main thread;
    ``signals=()`` disables trapping."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.tripped = False
        self._signals = tuple(signals)
        self._prev: dict = {}

    def __enter__(self):
        for sig in self._signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread
                pass
        return self

    def _handler(self, signum, frame):
        self.tripped = True
        mprint(f"caught signal {signum}: checkpointing at the next chunk "
               "boundary, then stopping")

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            # a handler installed outside Python reads back as None: the
            # default action keeps the process terminable
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        return False


class CplMixVAE:
    """Coupled mixture-VAE: model lifecycle, training and batched
    inference."""

    def __init__(self, saving_folder: str = "", aug_file: Optional[str] = None,
                 device="cuda", seed: int = 546, use_wandb: bool = False):
        self.folder = saving_folder
        if saving_folder:
            os.makedirs(saving_folder, exist_ok=True)
        self.device = resolve_device(device)
        self.seed = seed
        self.use_wandb = use_wandb
        self.models: list[dict] = []   # filled by append()
        self.aug_file = aug_file
        self._aug_loaded = None  # (params, bn, cfg) of the frozen augmenter
        self._aug_apply = None   # its closure in the compute dtype (cached)
        self.cfg: Optional[VAEConfig] = None
        self.tcfg: Optional[TrainConfig] = None
        self.state: Optional[TrainState] = None
        self.tx = None
        self.mesh = None   # parallel.sharding.Mesh on several devices
        self.specs = None  # its StateSpecs
        self.temp = 1.0
        self.resume_progress: dict = {}
        self._preempt: Optional[PreemptionGuard] = None
        self._eval_step = None
        self._eval_runner = None
        if aug_file:
            self._load_augmenter(aug_file)

    # -- model lifecycle ----------------------------------------------------

    def _load_augmenter(self, aug_file: str) -> None:
        """Load a frozen pre-trained augmenter onto the model's device
        (reference ``mk_augmenter``, cpl_mixvae.py:128-149).  The weights
        are kept in f32; ``_augment_fn`` casts them once the compute dtype
        is known.  The cached eval functions close over the augmenter, so
        they are dropped."""
        from dvae_tpu_torch.augment.augmenter import load_augmenter
        self._aug_loaded = load_augmenter(aug_file, self.device)
        self._reset_eval_fns()

    def _augment_fn(self):
        """The augmenter as the step and eval functions take it,
        fn(x, n_arm, generator, draws) → (A, B, D), or None without one:
        noise scale ``tcfg.aug_noise``, bf16 weights under ``tcfg.bf16``."""
        if self._aug_loaded is None:
            return None
        if self._aug_apply is None:
            from dvae_tpu_torch.augment.augmenter import make_augment_apply
            bf16 = self.tcfg is not None and self.tcfg.bf16
            self._aug_apply = make_augment_apply(
                *self._aug_loaded, dtype=torch.bfloat16 if bf16 else None)
        from dvae_tpu_torch.augment.augmenter import AugNoise
        aug = self._aug_apply
        scale = self.tcfg.aug_noise if self.tcfg else 0.1

        def fn(x, n_arm, generator=None, draws=None):
            return aug(x, n_arm, scale, generator, draws or AugNoise())
        return fn

    def _fused_default(self) -> bool:
        return self.device.type == "cuda"

    @staticmethod
    def _check_mode(cfg: VAEConfig) -> None:
        if cfg.mode not in ("MSE", "ZINB"):
            raise ValueError(f"unknown reconstruction mode {cfg.mode!r}")

    def _use_mesh(self, mesh: MeshConfig) -> None:
        """Join ``mesh`` (several devices: this process's rank of the world
        it has joined, which must have ``mesh.n_devices`` processes) or
        leave any."""
        if mesh.n_devices > 1:
            self.mesh = make_mesh(mesh)
            self.device = rank_device(self.device)
        else:
            self.mesh = None

    def _place(self, state: TrainState) -> TrainState:
        """A whole state cut to this rank's blocks (as is off a mesh)."""
        if self.mesh is None:
            self.specs = None
            return state
        self.specs = state_specs(self.cfg, self.tcfg.sharding, self.mesh)
        return place_state(state, self.specs, self.mesh)

    @property
    def is_writer(self) -> bool:
        """True on the rank that writes files (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def init_model(self, n_categories: int = 92, state_dim: int = 2,
                   input_dim: int = 5032, fc_dim: int = 100,
                   lowD_dim: int = 10, x_drop: float = 0.5,
                   s_drop: float = 0.2, lr: float = 1e-3, lam: float = 1.0,
                   lam_pc: float = 1.0, n_arm: int = 2, temp: float = 1.0,
                   tau: float = 0.005, beta: float = 1.0, hard: bool = False,
                   variational: bool = True, ref_prior: bool = False,
                   trained_model: Optional[str] = None, n_pr: int = 0,
                   mode: str = "MSE", optimizer: str = "adam",
                   batch_size: int = 5000, epochs_per_jit: int = 10,
                   sharding="no", mesh: Optional[MeshConfig] = None,
                   bf16: bool = False, rng_impl: str = "threefry2x32",
                   fused: Optional[bool] = None, shuffle_block: int = 1,
                   stream: bool = False, ckpt_every: int = 10,
                   eval_every: int = 10, align_arms_every: int = 0,
                   local_bn_stats: bool = False, **extra) -> None:
        """Build the configs, the optimizer and a fresh state (reference
        ``init_model``, cpl_mixvae.py:193-286; the JAX package's signature).
        ``fused`` turns on the fused encoder and reconstruction-loss
        kernels (MSE or ZINB, by ``mode``); None turns them on on CUDA.  ``rng_impl`` names a JAX PRNG and is kept
        for the checkpoint's metadata: the port draws from
        ``torch.Generator`` whatever it says.  ``extra`` passes any other
        ``VAEConfig`` field."""
        if fused is None:
            fused = self._fused_default()
        extra.setdefault("fused_recon", fused)
        extra.setdefault("fused_encoder", fused)
        mesh = mesh or MeshConfig()
        if local_bn_stats:
            extra.setdefault("bn_groups", max(1, mesh.data * mesh.fsdp))
        # fused_decoder stays opt-in, as in the JAX package: it arrives
        # through ``extra`` and no default turns it on
        cfg = VAEConfig(
            n_categories=n_categories, state_dim=state_dim,
            input_dim=input_dim, fc_dim=fc_dim, lowD_dim=lowD_dim,
            x_drop=x_drop, s_drop=s_drop, lr=lr, lam=lam, lam_pc=lam_pc,
            n_arm=n_arm, temp=temp, tau=tau, beta=beta, hard=hard,
            variational=variational, ref_prior=ref_prior,
            trained_model=trained_model, n_pr=n_pr, mode=mode, **extra)
        tcfg = TrainConfig(
            batch_size=batch_size, epochs_per_jit=epochs_per_jit,
            optimizer=optimizer, sharding=ShardingStrategy(sharding),
            mesh=mesh, bf16=bf16, seed=self.seed, rng_impl=rng_impl,
            shuffle_block=shuffle_block, stream=stream,
            ckpt_every=ckpt_every, eval_every=eval_every,
            align_arms_every=align_arms_every)
        self._check_mode(cfg)
        self._use_mesh(mesh)
        self.cfg, self.tcfg, self.temp = cfg, tcfg, temp
        self.tx = make_optimizer(cfg, optimizer)
        state = init_train_state(self.seed, cfg, self.tx, self.device)
        if n_pr > 0:
            # start with the n_pr last categories pruned (reference n_pr)
            state.mask[-n_pr:] = 0.0
        self.state = self._place(state)
        self._reset_eval_fns()
        if trained_model:
            self.load_model(trained_model)

    def append(self, **kwargs) -> dict:
        """Build one more model (cfg, tcfg, state, optimizer) and add it to
        ``self.models`` (reference ``append``, cpl_mixvae.py:288-315): the
        keywords of ``init_model``, ``trained_model=`` included.  The
        trainer's own model is left as it was."""
        saved = (self.cfg, self.tcfg, self.state, self.tx, self.temp,
                 self.resume_progress, self.mesh, self.specs, self.device)
        try:
            self.init_model(**kwargs)
            entry = {"cfg": self.cfg, "tcfg": self.tcfg, "state": self.state,
                     "tx": self.tx, "mesh": self.mesh}
            self.models.append(entry)
            return entry
        finally:
            (self.cfg, self.tcfg, self.state, self.tx, self.temp,
             self.resume_progress, self.mesh, self.specs,
             self.device) = saved
            self._reset_eval_fns()

    def _reset_eval_fns(self) -> None:
        """Drop the cached eval functions and the cast augmenter closure:
        they bake in the configs, a cast copy of the parameters and the
        augmenter's weights."""
        self._eval_step = None
        self._eval_runner = None
        self._aug_apply = None

    def load_model(self, filename: str) -> int:
        """Restore the model and optimizer state from a checkpoint written
        by either package (reference ``load_model``, cpl_mixvae.py:317).  On
        a fresh instance the configs are rebuilt from the metadata.  The
        checkpoint's phase progress is kept in ``resume_progress`` for the
        next ``train``.  Returns the stored epoch (or -1)."""
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
            # a checkpoint of a mesh larger than this world still serves:
            # inference needs no mesh (dvae_tpu/train/cpl_mixvae.py:321-331)
            want, (_, world) = self.tcfg.mesh, process_info()
            if want.n_devices > 1 and want.n_devices > world:
                mprint(f"checkpoint was trained on a {want.n_devices}-device "
                       f"mesh; this world has {world} — loading unsharded "
                       "(fine for eval; re-init for training)")
                self.tcfg = self.tcfg.replace(mesh=MeshConfig())
            self._use_mesh(self.tcfg.mesh)
            if self._fused_default():
                # how the model was trained does not decide how it runs
                # here: on CUDA the kernels are the path
                self.cfg = self.cfg.replace(fused_recon=True,
                                            fused_encoder=True)
            self.tx = make_optimizer(self.cfg, self.tcfg.optimizer)
        seed = (_seed_from_key_data(tree["key_data"]) if "key_data" in tree
                else self.seed + int(meta.get("epoch", 0)))
        params = params_from_jax(tree["params"], self.device)
        adam = adam_state_from_jax(tree.get("opt_state"))
        if adam is None:
            opt_state = self.tx.init(params)
        else:
            count, mu, nu = adam
            opt_state = AdamState(count, params_from_jax(mu, self.device),
                                  params_from_jax(nu, self.device))
        self.state = self._place(TrainState(
            params=params, bn=bn_from_jax(tree["bn"], self.device),
            mask=torch.from_numpy(np.array(tree["mask"])).to(self.device),
            seed=seed, epoch=int(meta.get("epoch", 0)), opt_state=opt_state))
        self.resume_progress = dict(
            meta.get("progress")
            or {"main_epochs": int(meta.get("epoch", 0)), "pr_it": 0})
        self._reset_eval_fns()
        return int(meta.get("epoch", -1))

    @spanned("checkpoint")
    def save_checkpoint(self, tag: str) -> str:
        """Write the state in the JAX package's checkpoint format: the
        optimizer state as optax's, the noise seed as raw key words, and
        the phase progress for a resume.  On a mesh every rank gathers the
        whole state and rank 0 writes it; every rank returns the path once
        the file is there (the span ``dvae.checkpoint``)."""
        path = os.path.join(self.folder or ".", f"cpl_mixVAE_model_{tag}.ckpt")
        st = self.state
        if self.mesh is not None:
            st = gather_state(st, self.specs, self.mesh)
        opt = st.opt_state
        if isinstance(opt, AdamState):
            opt = adam_state_to_jax(
                opt.count, opt.mu, opt.nu,
                n_empty=2 if self.tcfg.optimizer == "adamw" else 1)
        tree = {"params": st.params, "bn": st.bn, "opt_state": opt,
                "mask": st.mask, "key_data": _key_data_from_seed(st.seed)}
        meta = {"epoch": int(st.epoch),
                "progress": {"main_epochs": int(getattr(self, "_main_done", 0)),
                             "pr_it": int(getattr(self, "_pr_it", 0)),
                             "prune_epochs": int(getattr(self, "_prune_done",
                                                         0))},
                "cfg": dict(self.cfg.__dict__),
                "tcfg": {**dataclasses.asdict(self.tcfg),
                         "sharding": self.tcfg.sharding.value}}
        if self.is_writer:
            save_checkpoint(path, tree, meta)
        if self.mesh is not None:
            barrier(self.mesh.world, self.device)
        return path

    # -- training -----------------------------------------------------------

    def _preempted(self) -> bool:
        return self._preempt is not None and self._preempt.tripped

    def _resident(self, x, dtype) -> torch.Tensor:
        """The dataset on the model's device in ``dtype`` (used in place
        when it is there already)."""
        if hasattr(x, "toarray"):  # the resident path is dense
            x = x.toarray()
        return put_dataset(x, dtype, self.device)

    def train(self, x_train, x_val=None, n_epoch: int = 100,
              n_epoch_p: int = 0, c_p: Optional[np.ndarray] = None,
              train_idx: Optional[np.ndarray] = None,
              val_idx: Optional[np.ndarray] = None,
              min_con: float = 0.99, max_prun_it: int = 0,
              temp: Optional[float] = None,
              early_stop_consensus: Optional[float] = None,
              run_name: Optional[str] = None,
              save_plots: bool = True) -> str:
        """Main and pruning phases (reference ``train``,
        cpl_mixvae.py:323-1448; dvae_tpu/train/cpl_mixvae.py:420-600).
        Returns the final checkpoint's path.

        ``x_train`` (N, D): numpy, a scipy sparse matrix, or a tensor (used
        in place when it is on the model's device in the storage dtype, f32
        or bf16 under ``bf16``).  Under ``stream`` (or when the dataset
        would take more than 0.7 of the card's memory, which switches it
        on) it stays on the host, cast once to the storage dtype, a sparse
        matrix as CSR, and batches stream to the device.  A sparse
        ``x_val`` stays on the host; a dense one goes to the device once.
        ``c_p``: the (N_total, C) ref-prior table gathered by ``train_idx``
        (and ``val_idx`` for validation) under ref_prior.
        After ``load_model`` the checkpoint's progress carries over:
        completed main epochs and prune iterations count.  ``run_name``
        names the wandb run under ``use_wandb``.
        ``save_plots``: at the end, with a run folder, write the loss curve
        and the consensus matrices there (one more labelling pass over
        ``x_train``)."""
        if self.state is None:
            raise RuntimeError("call init_model or load_model first")
        cfg, tcfg = self.cfg, self.tcfg
        self._check_mode(cfg)
        temp = self.temp if temp is None else temp
        prog = self.resume_progress or {}
        self._main_done = int(prog.get("main_epochs", 0))
        self._pr_it = int(prog.get("pr_it", 0))
        self._prune_done = int(prog.get("prune_epochs", 0))
        self.resume_progress = {}
        self._halted = False
        stop_con = (tcfg.good_enuf_consensus if early_stop_consensus is None
                    else early_stop_consensus)
        logger = MetricLogger(
            use_wandb=self.use_wandb, run_name=run_name,
            jsonl_path=(os.path.join(self.folder, "metrics.jsonl")
                        if self.folder and self.is_writer else None),
            config={**cfg.__dict__, "n_epoch": n_epoch})

        n_train = x_train.shape[0]
        store = torch.bfloat16 if tcfg.bf16 else torch.float32
        if not tcfg.stream and _dataset_exceeds_device(x_train, store,
                                                       self.device):
            mprint("dataset does not fit in device memory alongside the "
                   "training state — falling back to host→device "
                   "streaming (TrainConfig.stream)")
            tcfg = self.tcfg = tcfg.replace(stream=True)
        prior_all = prior_val = None
        if cfg.ref_prior and c_p is not None:
            idx = np.arange(n_train) if train_idx is None else train_idx
            prior_all = np.asarray(np.asarray(c_p)[idx], np.float32)
        self._reset_eval_fns()
        augment = self._augment_fn()
        if tcfg.stream:
            x_all = _host_matrix(x_train, store)
            runner = make_streaming_runner(cfg, tcfg, self.tx, n_train,
                                           augment=augment,
                                           device=self.device,
                                           mesh=self.mesh)
        else:
            x_all = self._resident(x_train, store)
            if prior_all is not None:
                prior_all = self._resident(prior_all, torch.float32)
            runners = {}

            def runner(n_chunk: int):
                if n_chunk not in runners:
                    runners[n_chunk] = make_epoch_runner(
                        cfg, tcfg, self.tx, n_train,
                        epochs_per_chunk=n_chunk, augment=augment,
                        mesh=self.mesh)
                return runners[n_chunk]

        if x_val is not None:
            x_val = (x_val.tocsr() if hasattr(x_val, "toarray")
                     else self._resident(x_val, self._eval_dtype()))
            if cfg.ref_prior and c_p is not None:
                if val_idx is not None:
                    prior_val = np.asarray(c_p)[val_idx]
                else:
                    mprint("ref_prior: no val_idx given — validation runs "
                           "without the prior")

        self._preempt = PreemptionGuard()
        try:
            with self._preempt:
                self._run_phase(runner, x_all, prior_all, x_val, n_epoch,
                                temp, stop_con, logger, phase="train",
                                prior_val=prior_val)
                if (n_epoch_p > 0 and max_prun_it > 0
                        and not self._preempted() and not self._halted):
                    self._prune(runner, x_all, prior_all, x_val, n_epoch_p,
                                temp, stop_con, logger, prior_val, min_con,
                                max_prun_it)
                if self._halted:
                    # never save the NaN-poisoned state: point at the last
                    # good checkpoint instead
                    path = ((latest_checkpoint(self.folder)
                             if self.folder else None)
                            or newest_checkpoint(self.folder) or "")
                else:
                    path = self.save_checkpoint(f"epoch_{self.state.epoch}")
                if (self.folder and save_plots and not self._preempted()
                        and not self._halted):
                    from dvae_tpu_torch.utils.plots import (
                        save_training_artifacts)
                    labels = self._predict_labels(x_all, temp)
                    if self.is_writer:
                        save_training_artifacts(self.folder, logger.history,
                                                labels=labels,
                                                K=cfg.n_categories)
        finally:
            self._preempt = None
            logger.finish()
        return path

    def _prune(self, runner, x_all, prior_all, x_val, n_epoch_p, temp,
               stop_con, logger, prior_val, min_con, max_prun_it) -> None:
        """Pruning phase (reference cpl_mixvae.py:996-1444): remove the
        active category whose arms agree least, retrain, repeat."""
        cfg = self.cfg
        pr_it = self._pr_it
        # a run stopped during a retraining finishes that iteration first
        if self._prune_done < n_epoch_p and pr_it > 0:
            self._run_phase(runner, x_all, prior_all, x_val,
                            n_epoch_p - self._prune_done, temp, stop_con,
                            logger, phase=f"prune{pr_it - 1}",
                            prior_val=prior_val)
        while (pr_it < max_prun_it and not self._preempted()
               and not self._halted):
            labels = self._predict_labels(x_all, temp)
            agreement = per_category_agreement(labels, cfg.n_categories)
            mask = self.state.mask.cpu().numpy().copy()
            active = np.where(mask > 0)[0]
            agree_active = agreement[active]
            if float(np.min(agree_active)) > min_con:
                mprint("No more pruning!")
                break
            kill = active[int(np.argmin(agree_active))]
            mask[kill] = 0.0
            mprint(f"pruning iteration {pr_it}: pruned category {kill} "
                   f"(agreement {agreement[kill]:.3f}); "
                   f"{int(mask.sum())}/{cfg.n_categories} remain")
            self.state = self.state._replace(
                mask=torch.from_numpy(mask).to(self.state.mask))
            self._pr_it = pr_it + 1
            self._prune_done = 0
            self.save_checkpoint(f"before_pruning_{pr_it}_A{cfg.n_arm}")
            self._run_phase(runner, x_all, prior_all, x_val, n_epoch_p, temp,
                            stop_con, logger, phase=f"prune{pr_it}",
                            prior_val=prior_val)
            pr_it += 1

    def _run_phase(self, runner, x_all, prior_all, x_val, n_epoch, temp,
                   stop_con, logger, phase: str, prior_val=None) -> None:
        """Chunks of ``epochs_per_jit`` epochs (dvae_tpu/train/
        cpl_mixvae.py:619-765): the host reads the chunk's metrics once,
        then logs, validates, checkpoints and decides to stop."""
        cfg, tcfg = self.cfg, self.tcfg
        E = tcfg.epochs_per_jit
        done = 0
        best_con = -1.0

        def crossed(cadence: int) -> bool:
            c = max(cadence, 1)
            return (done // c) > ((done - n_chunk) // c)

        while done < n_epoch:
            n_chunk = min(E, n_epoch - done)
            t0 = time.perf_counter()
            self.state, ems = runner(n_chunk)(self.state, x_all, prior_all,
                                              temp)
            ems = {k: v.cpu().numpy() for k, v in ems._asdict().items()}
            dt = time.perf_counter() - t0
            total, cons = ems["total"], ems["consensus"]
            mem = device_memory_mb(self.device)
            base = self.state.epoch - n_chunk
            for e in range(n_chunk):
                logger.log({
                    f"{phase}/loss": float(total[e]),
                    f"{phase}/loss_joint": float(ems["loss_joint"][e]),
                    f"{phase}/neg_joint_entropy": float(ems["neg_entropy"][e]),
                    f"{phase}/simplex_distance": float(ems["c_dist"][e]),
                    f"{phase}/l2_distance": float(ems["c_l2_dist"][e]),
                    f"{phase}/consensus": float(cons[e]),
                    f"{phase}/epoch_time_s": dt / n_chunk,
                    f"{phase}/device_mb": mem,
                    **{f"{phase}/rec_loss_arm{a}": float(ems["loss_rec"][e, a])
                       for a in range(cfg.n_arm)},
                }, step=base + e)
            done += n_chunk
            if phase == "train":
                self._main_done += n_chunk
            elif phase.startswith("prune"):
                self._prune_done += n_chunk
            epoch = self.state.epoch
            mprint(f"[{phase}] epoch {epoch}: loss={total[-1]:.3f} "
                   f"consensus={cons[-1]:.3f} ({dt / n_chunk:.3f}s/epoch)")

            # a non-finite loss poisons the Adam moments: stop the run; the
            # checkpoint trail keeps the last good state
            if tcfg.halt_on_nan and not np.isfinite(total[-1]):
                mprint(f"HALT: non-finite loss at epoch {epoch} "
                       f"(total={total[-1]}); the last good checkpoint is the "
                       "newest best_/epoch_ file")
                self._halted = True
                break

            # cross-arm category alignment (train/alignment.py; off by
            # default), main and prune phases: under a pruned mask the match
            # is restricted to active categories; ref_prior pins the index
            # space, so it stays gated
            if (tcfg.align_arms_every and cfg.n_arm > 1
                    and not cfg.ref_prior
                    and crossed(tcfg.align_arms_every)):
                self._align(x_all, temp, logger, phase, epoch)

            if x_val is not None and crossed(tcfg.eval_every):
                val = self.validate(x_val, temp, c_p=prior_val)
                logger.log({f"val/{k}": v for k, v in val.items()},
                           step=epoch)
                mprint(f"[val] loss={val['loss']:.3f} "
                       f"consensus={val['consensus']:.3f}")
            if crossed(tcfg.ckpt_every):
                self.save_checkpoint(f"epoch_{epoch}")
            if float(cons[-1]) > best_con:
                best_con = float(cons[-1])
                self.save_checkpoint(f"best_{phase}")
            # consensus early stop (reference cpl_mixvae.py:851-927)
            if stop_con and float(cons[-1]) >= stop_con:
                mprint(f"early stop: consensus {cons[-1]:.3f} >= {stop_con}")
                self.save_checkpoint(f"epoch_{epoch}")
                break
            if self._preempted():
                self.save_checkpoint(f"preempt_epoch_{epoch}")
                mprint(f"preempted: checkpointed at epoch {epoch}")
                break

    def _align(self, x_all, temp, logger, phase: str, epoch: int) -> None:
        """One alignment move (dvae_tpu/train/cpl_mixvae.py:710-738): the
        eval-mode labels of the first min(N, 4·batch_size) cells decide the
        per-arm permutations; parameters and Adam moments are permuted."""
        cfg, tcfg = self.cfg, self.tcfg
        n_sub = min(x_all.shape[0], 4 * tcfg.batch_size)
        lab = self._predict_labels(x_all[:n_sub], temp,
                                   batch_size=tcfg.batch_size)
        self.state, m, moved = align_state(
            self.state, lab, cfg, mask=self.state.mask.cpu().numpy(),
            shards=None if self.mesh is None else (self.specs, self.mesh))
        if not moved:
            return
        # the eval functions may hold a cast copy of the old parameters
        self._reset_eval_fns()
        _, active = moved_counts(m, lab)
        con0 = consensus_from_labels(lab, cfg.n_categories)
        con1 = consensus_from_labels(np.take_along_axis(m, lab, axis=1),
                                     cfg.n_categories)
        mprint(f"[align] epoch {epoch}: remapped {moved} category indices "
               f"({active} active); label consensus {con0:.3f} -> "
               f"{con1:.3f}")
        logger.log({f"{phase}/align_moved": moved,
                    f"{phase}/align_moved_active": active,
                    f"{phase}/align_consensus": con1}, step=epoch)

    # -- evaluation ---------------------------------------------------------

    def _eval_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.tcfg.bf16 else torch.float32

    def _ensure_eval_fns(self) -> None:
        if self.state is None:
            raise RuntimeError("call init_model or load_model first")
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.cfg, self.tcfg,
                                             self._augment_fn(), self.mesh)
        if self._eval_runner is None:
            self._eval_runner = make_eval_runner(self.cfg, self.tcfg,
                                                 self._augment_fn(),
                                                 self.mesh)

    def _eval_input(self, x):
        """The dataset as the eval surfaces take it: a sparse matrix as CSR
        on the host, a dense host matrix that would not fit the card as a
        CPU tensor, anything else on the model's device in the eval dtype
        (no copy when it is there already)."""
        if hasattr(x, "toarray"):
            return x.tocsr()
        dtype = self._eval_dtype()
        if (not (isinstance(x, torch.Tensor) and x.device == self.device)
                and _dataset_exceeds_device(x, dtype, self.device)):
            return as_host_tensor(x)
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def _eval_batches(self, x_all, batch_size: int, c_p=None):
        """Yield ``("chunk", x (K, B, D), prior)`` chunks of K ≤ 8 full
        batches for the eval runner, then ``("batch", x (b, D), prior)``
        for the leftovers (dvae_tpu/train/cpl_mixvae.py:788-823).  A host
        matrix (``_eval_input``) goes batch by batch: each (b, D) slice is
        densified and cast to the eval dtype on the host, then moved."""
        n = x_all.shape[0]
        prior = (None if c_p is None else
                 torch.as_tensor(np.asarray(c_p), dtype=torch.float32)
                 .to(self.device))
        host = hasattr(x_all, "toarray") or x_all.device != self.device
        i = 0
        K = min(8, n // batch_size)
        if not host and K >= 2:
            while n - i >= K * batch_size:
                chunk = x_all[i: i + K * batch_size].reshape(
                    K, batch_size, *x_all.shape[1:])
                pc = (None if prior is None else
                      prior[i: i + K * batch_size].reshape(K, batch_size, -1))
                yield "chunk", chunk, pc
                i += K * batch_size
        for i in range(i, n, batch_size):
            pb = None if prior is None else prior[i: i + batch_size]
            xb = x_all[i: i + batch_size]
            if host:
                if hasattr(xb, "toarray"):
                    xb = torch.from_numpy(xb.toarray())
                xb = xb.to(self._eval_dtype()).to(self.device)
            yield "batch", xb, pb

    def _predict_labels(self, x_all, temp, batch_size: int = 5000):
        """Eval-mode argmax labels over a dataset → (A, N) numpy."""
        self._ensure_eval_fns()
        x_all = self._eval_input(x_all)
        outs = []
        for kind, xb, _ in self._eval_batches(x_all, batch_size):
            with span("eval.batch"):
                if kind == "chunk":
                    _, f = self._eval_runner(self.state, xb, temp)
                    outs.append(f.lab)
                else:
                    _, labels, _ = self._eval_step(self.state, xb, None, temp)
                    outs.append(labels)
        with span("eval.drain"):
            return torch.cat(outs, dim=1).cpu().numpy()

    @spanned("validate")
    def validate(self, x_val, temp: float = 1.0, batch_size: int = 5000,
                 c_p=None) -> dict:
        """Validation losses + consensus (reference val loop,
        cpl_mixvae.py:563-761).  Spans: ``dvae.validate`` around the call,
        ``dvae.eval.batch`` a batch or chunk, ``dvae.eval.drain`` the reads
        of the losses, ``dvae.eval.finish`` the consensus and averages."""
        self._ensure_eval_fns()
        x = self._eval_input(x_val)
        tot, recs, labels, sizes = [], [], [], []
        for kind, xb, pb in self._eval_batches(x, batch_size, c_p):
            with span("eval.batch"):
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
        with span("eval.drain"):
            tot = torch.cat(tot).cpu().numpy()
            recs = torch.cat(recs, dim=0).cpu().numpy()
        with span("eval.finish"):
            cons, cons_active = (float(v) for v in consensus_device_both(
                torch.cat(labels, dim=1), self.cfg.n_categories))
            rec = np.average(recs, axis=0, weights=sizes)
        return {"loss": float(np.average(tot, weights=sizes)),
                "consensus": cons,
                "consensus_active": cons_active,
                **{f"rec_loss_arm{a}": float(rec[a])
                   for a in range(self.cfg.n_arm)}}

    @spanned("eval")
    def eval_model(self, x, temp: float = 1.0, batch_size: int = 5000,
                   c_p=None) -> dict:
        """Batched no-grad inference over a dataset (reference
        ``eval_model``, cpl_mixvae.py:1450-1619).  ``x``: (N, D) numpy
        array, scipy sparse matrix or tensor; a tensor already on the
        device in the eval dtype is used in place, a sparse matrix (or a
        dense one too large for the card) goes batch by batch.

        Returns per-arm ``c_prob`` (A,N,C), ``state_mu``/``state_logvar``
        (A,N,S), ``x_low`` (A,N,L), ``pred_label`` (A,N), the batch-size
        weighted ``total_loss`` and ``total_loss_rec`` (A,), the consensus
        over arms and the category ``mask`` — all numpy.

        Spans: ``dvae.eval`` around the call, ``dvae.eval.batch`` a batch
        or chunk enqueued, ``dvae.eval.drain`` each read of results (the
        wait for the card and the copy into numpy), ``dvae.eval.finish``
        the weighted averages and the consensus after the last read.
        """
        self._ensure_eval_fns()
        xd = self._eval_input(x)
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
            with span("eval.batch"):
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
                with span("eval.drain"):
                    for d in fields.values():
                        drain_field(d)
                pending = 0

        def flush(key):
            d = fields[key]
            drain_field(d)
            parts = d["host"]
            return parts[0] if len(parts) == 1 else np.concatenate(parts,
                                                                   axis=1)

        with span("eval.drain"):  # every read before the host finish
            labels = flush("lab")
            out = {"c_prob": flush("c"), "state_mu": flush("s_mean"),
                   "state_logvar": flush("s_logvar"),
                   "x_low": flush("x_low"), "pred_label": labels}
            totals = torch.cat(totals).cpu().numpy()
            recs = torch.cat(recs, dim=0).cpu().numpy()
            mask = self.state.mask.cpu().numpy()
        with span("eval.finish"):
            w = np.asarray(sizes, np.float64)
            out["total_loss"] = float(np.average(totals, weights=w))
            out["total_loss_rec"] = np.average(recs, axis=0, weights=w)
            out["consensus"] = consensus_from_labels(labels,
                                                     self.cfg.n_categories)
        out["mask"] = mask
        return out

    # -- files of named arrays -----------------------------------------------

    def save_file(self, fname: str, **kwargs) -> None:
        """Pickle named arrays (reference ``save_file``,
        cpl_mixvae.py:1621-1639)."""
        with open(fname, "wb") as f:
            pickle.dump(kwargs, f, protocol=pickle.HIGHEST_PROTOCOL)

    def load_file(self, fname: str) -> dict:
        """Unpickle a ``save_file`` file (reference ``load_file``,
        cpl_mixvae.py:1641-1650)."""
        with open(fname, "rb") as f:
            return pickle.load(f)
