#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dvae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits non-zero and prints no result line):
  1. build every CUDA kernel of the port from ``dvae_tpu_torch/csrc`` (one
     nvcc per source, all started together);
  2. hold each of the thirteen kernels (and the sharpen variant of the
     Gumbel forward) against its plain PyTorch version: the eight of the
     reconstruction paths at
     the shapes the serving and training paths give it (f32 and bf16,
     shared and per-arm x, B=5000 and the ragged 2,000; the ZINB kernels
     on inputs with exact zeros, non-positive rates, x up to log1p(1e6)
     and a column of counts beyond 5e9; the ZINB kernels and #2, #3 each
     case twice: with y (of the rate head) on a grid on which every order
     of its sums is exact, every output held, and off it, every output
     held that the ReLU kink cannot reach: for the ZINB kernels all but
     dh, dW_r, db_r, which are printed beside the draw's y nearest the
     kink; for #2 and #3 dh on the rows and dW, db on the columns whose
     plain y all stay clear of it), check the in-kernel dropout mask
     (bit for bit against its numpy version, keep fraction, forward and
     backward fed the materialised mask), that the separate backward
     kernels at cotangent 1 reproduce the fused kernels' gradients; the
     Gumbel forward and backward and the coupling distance at (A=5,
     B=5000, C=92), ragged rows and C up to 300 (the Gumbel kernels also
     at C = 513, 600, 1024, 2048 and 4099, and the forward's row plan
     against its Python twin), with given uniforms and with the in-kernel
     ones (bit for bit against their numpy version, and the seeded forward
     against the forward fed them), hard samples, pruned categories, the
     coupling distance past 10 arms and 1024 categories (fault C8: (12,
     5000, 92), (5, 5000, 1100), (5, 5000, 4099), (16, 2000, 1100)), dphi
     and dtemp also against autograd of the eager formula, one kernel a
     call by the profiler's names, the coupling distance on posteriors with
     dead categories and a collapsed arm; the two whole-decoder kernels at the
     production widths (f32 and bf16, shared and per-arm x, B=5000 and
     2,000, each on a uniform draw and on one whose trunk and output layer
     lie on a grid, with and without the mismatch count, a per-arm
     cotangent through autograd, a NaN in z, a trunk weight or W11 of one
     arm, the quiet one and the card's own; end to end against the plain
     version, and pass by pass on the call's own workspaces: the trunk's
     activations against the plain forward, #2 on its own h5 bit for bit,
     the trunk backward against the plain one on its own activations and
     dh5; the output layer's gradients against #2's on the plain h5, bit
     for bit on the grid); #2 with a NaN in h or W of one arm, the quiet
     one and the card's own; a NaN of x (either encoding) where r > 0 and
     where r = 0 for #2, #3, #12 and #13 on the grid draws: NaN where the
     plain version is, every other element bit for bit the clean input's;
     #1 (on wgmma) also on grid draws (mism exact, sumsq within 1e-6), at
     a ragged F, an F past one resident chunk and rows of x not 16-byte
     aligned, with a NaN in h, W or x of one arm or in shared x, its plan
     against the CPU tests' twin, and timed beside #12's value-only row
     pass on the same inputs, which it must beat;
     the row plan of #2 (its rules, and the Python twin's plan); that
     repeated launches are bit-identical; and
     time kernel, plain version and library call (for the tensor-core
     kernels #2-#8 in f32 and bf16 with the tensor-core bound, the passes
     of #2, #3 and the ZINB kernels on the device, #4's Philox floor and #4 and #5 with
     the mask off, explicit and drawn in the kernel; #6's value against
     #7's loss, bit for bit);
  3. drive the serving path end to end at the production width (A=5 arms,
     D=5032 genes, F=100, L=10, C=92, S=2; random weights from a seed):
     init → save_checkpoint → a fresh CplMixVAE.load_model → eval_model over
     42,000 synthetic cells (one 8-batch runner chunk plus a 2,000-row
     tail), with launch counts reset just before and read just after, and
     check the result against the port's CPU path on a small input;
  4. drive the training path at the same width: init_model → train over
     40,000 cells with 2,000 for validation, 4 epochs in chunks of 2
     (32 steps), counts reset just before and read just after; resume from
     the last checkpoint; one step against the port's CPU path with the
     same explicit noise; warm throughput, a profiler breakdown of one
     chunk and its count of synchronising calls;
  5. drive ZINB mode at the same width on hard synthetic count data made
     with the port's own sampler: init_model(mode="ZINB") → train over
     20,000 cells with 2,000 for validation, 4 epochs in chunks of 2
     (16 steps), counts reset just before and read just after; resume;
     save → a fresh load_model → eval_model over the 22,000 cells, counts
     again; one training step and one served batch against the port's CPU
     path; warm throughput, profiler breakdown, synchronising calls;
  6. drive the categorical path at the same width: init_model(
     use_pallas=True, align_arms_every=2) → train over 20,000 cells with
     2,000 for validation, 4 epochs in chunks of 2 (16 steps, 2 alignments),
     counts reset just before and read just after (one gumbel_fwd,
     gumbel_bwd and coupling per step, one coupling more per eval batch);
     the alignment's invariance on one batch; save → a fresh load_model →
     eval_model, counts again; the card against the CPU path; warm
     throughput with and without use_pallas in turns, profiler breakdown,
     synchronising calls; then a short ZINB run with use_pallas; and the
     same path at n_categories=600 (4 steps, one alignment, one
     validation, then 12,000 cells served; counts, finite losses, the
     largest single allocation below one (A, B, D) f32 tensor) and at
     n_arm=12 (fault C8: #11's general kernel, the same run and checks);
  7. hold the frozen augmenter on the card against the port's CPU path for
     both committed checkpoints (2,000 cells, the same explicit noise; the
     per-arm fast path against the forward on the broadcast batch; the ZINB
     checkpoint's views zero where the data are);
  8. drive fused_decoder at the same width, once on a shared batch and once
     with ``CplMixVAE(aug_file=...)`` (per-arm views, the per-arm-target
     branch of every fused kernel): init_model(fused_decoder=True) → train
     over 20,000 cells with 2,000 for validation (16 steps) → a fresh
     load_model → eval_model, counts reset just before and read just after
     (one decoder_fwdbwd a step, one decoder_fwd an eval batch, recon_fwd
     and recon_fwdbwd never); peak memory; the card against the CPU path;
     warm throughput with and without the flag and the augmenter in turns,
     profiler breakdowns, synchronising calls; a short run with use_pallas;
  9. hidden widths past 128 (fc_dim=160) in MSE, ZINB and fused_decoder
     mode end to end;
 10. host->device streaming at the same width: the streamer's batches on
     the card bit for bit the host gather (dense f32, bf16, CSR); MSE
     training streamed from a dense host dataset of 150,000 cells (3.0 GB)
     for 2 epochs with a validation (the loss falls, the counters match the
     steps, the peak device memory below half of the dataset's bytes); a
     streamed chunk of 3 epochs bit for bit a manual step loop; the
     automatic switch; ZINB streamed from a CSR matrix, with validate and
     eval_model on CSR bit for bit the dense calls; streamed against
     resident ms/step, the host gather, the pinned link rate, feed_census's
     predicted overlap against the measured one, host waits and
     synchronising calls per chunk;
 11. the GAN that trains an augmenter and the quality recipe at production
     width: one GAN step (AugmenterConfig(), DiscriminatorConfig(5032), 2,000
     hard synthetic cells; MSE and ZINB, f32 and bf16) on the card against
     the CPU path and an f64 step with the same explicit noise (losses, the
     gate's decision, the f64 step the same function on both, every
     gradient leaf against f64, parameters after Adam; the trainer's 0.1%
     rule at the CPU tests' widths); train_augmenter over the 17,962
     training cells of that dataset, batch 5000, 3 epochs, MSE and ZINB in
     bf16 (finite metrics, mse_recon falling, one host read a chunk and no
     synchronising call inside it, the D-skip share, the peak memory
     rise), ms a step in f32 and bf16;
     the MSE augmenter it wrote through ``CplMixVAE(aug_file=...)`` (4
     steps, counted launches); examples.hard_synthetic.run at its recipe
     (A=2, bf16, batch 5000, 20,000 cells) for 4 epochs with that
     augmenter, its counted launches and numpy AMIs;
 12. the analysis and interop path at the same width: models.api.load_vae
     of phase 6's use_pallas checkpoint → generate over 12,000 cells (three
     batches, the last padded; one coupling launch a batch and no other
     kernel; the peak memory rise) against eval_model on the same noise
     and against the CPU path on 2,000 cells (labels, c_prob, state_mu,
     loss_rec, recon); mixvae.state_changes (d_s 0, 8 samples, 2,000
     cells) card against CPU, and the traversal study; evals2_files on
     phase 3's and phase 6's checkpoints over 22,000 cells (eval_model's
     launches; equal to evals2 of the two label sets); ``cli import-torch``
     of reference-layout .pth files made with torch from a seed (MSE with
     Adam moments, MSE with a pruned fcc, ZINB with Adam moments): the
     parameters, mask and moments bit for bit, then served on the card
     (recon_fwd or zinb_fwd) against the CPU path;
 13. the taxonomy and clusterability path at the same width:
     examples.taxonomy_study.run on a planted taxonomy of 64 leaves (20,000
     cells, 96 categories, A=5, batch 5000, 4 epochs: 12 steps of
     encoder_fwd, encoder_bwd and recon_fwdbwd, recon_fwd for the label
     pass and any validation, every other counter 0), its merge sweep
     rerun exactly, the card's labels against the CPU path's from the
     checkpoint it served; tree_based.get_merged_types from a dend CSV
     (read without pandas) equal to the tree in memory at every level
     2..64; then LDA and QDA 3-fold, the silhouette (card against CPU,
     1e-10), cluster_compare's PCA and K_selection on phase 12's generate
     output (x_low of arm 0, 12,000 cells), and the random forest: run
     where scikit-learn is, ImportError naming it where it is not;
 14. print the kernels line, the card's name and power limit, and last the
     ``{"ok": true, "device": ...}`` line.

Every ``train`` call passes ``save_plots=False``: the plot artifacts would
add one labelling pass over the training data to the counted launches.

``--kernels-only`` stops after phase 2 (a short first run of new kernels;
it prints no result line); ``--kernels-only=decoder,coupling`` runs just
the named kernel phases.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

SEED = 0
DEV = "cuda"
A, B, F, D, C = 5, 5000, 100, 5032, 92
N_CELLS, TAIL = 42000, 2000
N_SMALL = 2000
# NVIDIA H100 SXM data sheet: dense peaks and HBM3 rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the tensor-core peak the f32 operands of #2-#8 run at (3xTF32:
# three TF32 products a product, so one TF32 product is the least work)
PEAK_TF32 = 495e12
PEAK_BYTES_PER_S = 3.35e12
TOL_SUMSQ = {"float32": 1e-5, "bfloat16": 1e-4}   # relative, per arm
TOL_MISM = 1e-5                                    # × B·D, per arm
TOL_GRID_SUMSQ = 1e-6                              # y exact: #1 on the grid
# kernel vs plain, max |Δ| / max |plain|: f32 sums in another order; bf16
# outputs (y1) one bf16 rounding step; bf16 gradients: gm rounded to bf16
# on both sides from f32 values that differ in their last bits
TOL_REL = {"float32": 1e-5, "bfloat16": 1e-3}
TOL_Y_BF16 = 8e-3
# #2 and #3 off the grid: the rows of dh and the columns of dW and db held
# there are those on which every |y| of the plain version exceeds this.
# The kernel's y and cuBLAS's each lie within 1e-6 of the exact sum at this
# draw's spread (the CPU model of the plan, tests/test_torch_recon.py), so
# no element beyond it can part in sign between the two.
KINK_Y = 1e-5
# ZINB kernels vs their plain versions.  Loss sums, relative, per arm: f32
# sums in another order (bf16 operands are exact in f32, so one limit).
# Gradients, max |Δ| / max |plain|: the kernel fuses multiply-adds where
# ATen rounds twice, and the sums run in another order (f32); gm rounded to
# bf16 on both sides from f32 values that differ in their last bits (bf16).
TOL_ZINB_LOSS = 1e-5
TOL_ZINB_GRAD = {"float32": 1e-4, "bfloat16": 1e-3}
ZINB_EPS = 1e-6
X_MAX = 13.8                                       # log1p(1e6), logcpm's top
X_HUGE = 22.5                                      # expm1 = 5.9e9 > P4's overflow
RATE = 0.5                                         # x_drop of the model
N_TRAIN, N_VAL = 40000, 2000
# hard synthetic counts: fewer cells than the MSE phases, because the
# numpy half of the generator runs on the host (seconds for 22,000 cells)
N_ZINB_TRAIN, N_ZINB_VAL = 20000, 2000
N_PARITY = 2000
LR = 1e-3
# the categorical path (use_pallas + alignment): 4 steps an epoch
N_CAT_TRAIN, N_CAT_VAL = 20000, 2000
N_CAT_ZINB = 10000
N_CAT_WIDE = 600      # fault C7: rows past the 512 columns #10 held
N_ARM_WIDE = 12       # fault C8: more arms than #11's templated kernel
# phase 10, streaming: a dense host dataset of 3.0 GB f32 for the MSE run;
# smaller ones for the exact checks, the ZINB run on CSR and the timing
N_STREAM, N_STREAM_SMALL = 150000, 20000
N_STREAM_ZINB, N_STREAM_TIMED = 10000, 40000
# phase 11, the GAN and the quality recipe: train_augmenter's epochs at
# production width; the short n_epoch of examples.hard_synthetic.run
GAN_EPOCHS, HS_EPOCHS = 3, 4
# the GAN step, card vs CPU: losses in f32 (the binarized fakes' threshold
# and Bernoulli draws part on a few of 1e7 elements, each moving a BCE term
# by 1e-5); bf16 as tests/test_augment.py holds bf16 against f32.
TOL_GAN_LOSS = {False: 1e-4, True: 5e-2}
# The reference is the same step in f64 (cast_gan_state): the card's f64
# and the CPU path's agree to 6.7e-14 of a leaf's largest gradient.  Every
# gradient leaf, ‖Δ‖ / ‖f64‖ (scripts/torch_gan_precision.py; NVIDIA H100
# 80GB HBM3, 700 W): f32 read at most 1.7e-2 on the card and on the CPU.
# The cause is the ReLUs: a unit whose input lies within f32 rounding of 0
# is on in one precision and off in the other, 10-13 of the 1e7 output
# units and 0-4 a hidden norm, and each one moves a gradient leaf by
# ~1e-3; the card's f32 products carry 2.5x the CPU's rounding and switch
# more of them.  bf16 read at most 0.58: the 8-bit activations' rounding
# left after the norms subtract their batch means.  A gradient without one
# of its terms, of the wrong sign or twice too large reads 1 or more.
# After Adam's first step (about lr·sign(g)) the share of parameters
# beyond 1e-5 of the f64 step's reads 0.53% (card) and 0.35% (CPU) in MSE,
# 0.12% and 0.13% in ZINB: entries whose f64 gradient is ~3e-7 of the
# largest, so that rounding sets their sign.  The trainer's 0.1% holds at
# the tests' widths (0.002%) and for no f32 step at this width, the CPU's
# included; the share is held at 1% (a bf16 step reads 6-11%).
TOL_GAN_F64 = 1e-10
TOL_GAN_GRAD = {False: 5e-2, True: 0.85}
TOL_GAN_SHARE = 1e-2
# the biases of the layers that feed a batch norm: true gradient 0, what is
# computed is rounding
GAN_BN_FED = {"fc1", "fc2", "fc3", "fc4", "fc5", "fc5_plain", "fc6", "fc7",
              "fc8", "fc9", "fc10", "fc_mu"}
# Gumbel and coupling kernels vs their plain versions.  y, dphi and the
# Gram, max |Δ| / max |plain|: the same f32 formulas with logs, exps and
# sums a few roundings apart (fused multiply-adds, another summation
# order); dtemp and the distance, relative: sums of 2.3e6 terms of both
# signs, per-block f32 partials reduced in double against ATen's tree.
# Against autograd of the eager formula (another chain of roundings, the
# division by phi + eps included) ten times the limit, and for dtemp, which
# autograd takes through the logits and not through log y, the 3e-4 of
# tests/test_ops.py:183.  The two degenerate
# coupling inputs as tests/test_ops.py:71,88 hold them: what is left after
# centring constants of size 1.8e5 carries f32 rounding at that size.
TOL_GUMBEL = 1e-5
TOL_GUMBEL_AUTOGRAD = 1e-4
TOL_DTEMP_AUTOGRAD = 3e-4
TOL_GRAM = 2e-4
TOL_DIST = 1e-4
TOL_DIST_DEGENERATE = 5e-3
# fault C8: #11 past 10 arms or 1024 categories (its general kernel)
C8_SHAPES = [(12, 5000, 92), (5, 5000, 1100), (5, 5000, 4099),
             (16, 2000, 1100)]
GUMBEL_EPS = 1e-8
# The operations bound of the SIMT kernels #9-#11 counts SASS
# instructions, not flops: the H100 SXM issues 128 FP32 lane-instructions a
# clock on each of its 132 SMs, 33.5e12 a second (the flop rate halved: an
# FMA is two flops and one instruction); integer multiplies issue at half
# that rate.  The element math's instructions, from `cuobjdump -sass` of
# probe kernels built with the port's flags (scripts/gumbel_sass.py on the
# H100's toolkit, CUDA 12.8: the instructions of each probe's main path
# beyond an empty copy's): an accurate logf 26, expf 10, an IEEE division
# 13 (16, 3 of them the divisor's load; its slow path is a subroutine off
# the main path), a Philox4x32-10 draw 51, 19 of them integer multiplies,
# so 8 and 4.75 a uniform
PEAK_FP32_ISSUE = PEAK_FLOPS["float32"] / 2
OPS_LOG, OPS_EXP, OPS_DIV, OPS_PHILOX = 26, 10, 13, 8
PHILOX_MULS = 4.75
# a Gumbel-softmax element: three logs, one exp, its uniform, about ten
# adds, maxima, the uniform's conversion and the scalings by 1/T and by
# the reciprocal of the row sum (what #9 does for the two divisions, an
# ulp apart); its backward: one division, the log of dT, about eight
# multiply-adds and sums
OPS_GUMBEL_FWD = 3 * OPS_LOG + OPS_EXP + OPS_PHILOX + 10
OPS_GUMBEL_BWD = OPS_DIV + OPS_LOG + 8
TIMING_ITERS = 200           # launches per timing of the small kernels
# the whole-decoder kernels vs their plain versions: the sums as the other
# MSE kernels (TOL_SUMSQ, TOL_MISM); gradients, max |Δ| / max |plain|
TOL_DEC_GRAD = {"float32": 1e-5, "bfloat16": 1e-3}
# #13's trunk dW and db end to end on the uniform draws, f32: a row whose
# gm or gate flips at a ReLU kink (its y within rounding of 0, summed in
# another order than cuBLAS's) moves every one of them; measured up to
# 8.1e-5 of max|plain| on the H100 (PERF.md §6)
TOL_DEC_KINK = 1e-4
TOL_DEC_MISM = {"float32": TOL_MISM, "bfloat16": TOL_MISM}
# fused_decoder and the frozen augmenter: 4 steps an epoch
N_DEC_TRAIN, N_DEC_VAL = 20000, 2000
N_DEC_PALLAS = 10000
_HERE = os.path.dirname(os.path.abspath(__file__))
AUG_MSE = os.path.join(_HERE, "artifacts", "hard_synthetic",
                       "augmenter_MSE.ckpt")
AUG_ZINB = os.path.join(_HERE, "artifacts", "hard_synthetic",
                        "augmenter_ZINB.ckpt")


class Checks:
    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str) -> bool:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failed.append(what)
        return ok


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: its kernels' device time summed
    under torch.profiler over ``iters`` calls.  Unlike ``cuda_ms`` it leaves
    out the gaps in which the card waits for the host to enqueue; 0.0 where
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda) / iters / 1e3


def host_ms(torch, fn, iters: int = 100) -> float:
    """Wall time of one call of ``fn`` on the host's clock over ``iters``
    calls that end in one synchronise: the larger of what the host needs to
    enqueue the call and what the card needs to run it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def flops_bound_ms(flops, nbytes, dtype_name: str, tensor_cores=False):
    """(bound_ms, bound_by): the larger of the operations over the card's
    peak for the type and the bytes over its memory rate.  With
    ``tensor_cores`` f32 operations count at the TF32 tensor-core peak (the
    kernels whose f32 products run there, split in three)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    peak = (PEAK_TF32 if tensor_cores and dtype_name == "float32"
            else PEAK_FLOPS[dtype_name])
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def simt_bound_ms(instr, muls, nbytes):
    """(bound_ms, bound_by, bytes_ms, ops_ms) of a SIMT kernel: ``instr``
    lane-instructions at the FP32 issue rate and ``muls`` integer
    multiplies at half of it, against the bytes over the memory rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (instr + 2 * muls) / PEAK_FP32_ISSUE * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes
            else "bytes", t_bytes, t_ops)


def kernel_device_ms(torch, fn, iters: int = 5) -> dict:
    """Device ms per call of ``fn`` by kernel name under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for e in prof.key_averages():
        if e.device_type == cuda and e.self_device_time_total > 0:
            out[e.key] = out.get(e.key, 0.0) + (
                e.self_device_time_total / iters / 1e3)
    return out


def kernel_launches(torch, fn, iters: int = 5) -> dict:
    """Device kernels launched by one call of ``fn``, by name, under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: e.count / iters for e in prof.key_averages()
            if e.device_type == cuda and e.count}


def recon_bound_bytes(a, b, f, d, dtype_name: str, per_arm_x: bool):
    """Bytes of one fused recon forward: operands read once, the (A, 2)
    output written once."""
    item = 4 if dtype_name == "float32" else 2
    x_elems = (a if per_arm_x else 1) * b * d
    return (a * b * f + a * f * d + a * d + x_elems) * item + a * 2 * 4


def recon_bound_ms(a, b, f, d, dtype_name: str, per_arm_x: bool):
    """(bound_ms, bound_by) of one fused recon forward on the FP32 cores
    (f32) or the bf16 tensor cores: 2·A·B·F·D operations of the product."""
    return flops_bound_ms(2.0 * a * b * f * d,
                          recon_bound_bytes(a, b, f, d, dtype_name,
                                            per_arm_x), dtype_name)


def plain_ms(torch, fn, iters: int = 3) -> float:
    return cuda_ms(torch, fn, iters=iters, warmup=1)


def rel_err(torch, got, want) -> float:
    """max |got − want| / max |want|, in f32."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _counted_wrappers().items()}


def _counted_wrappers() -> dict:
    from dvae_tpu_torch.ops import (coupling, decoder, encoder, gumbel, recon,
                                    zinb)
    return {"decoder_fwd": decoder.fused_decoder_mse,
            "decoder_fwdbwd": decoder.decoder_fwdbwd,
            "gumbel_fwd": gumbel.gumbel_fwd,
            "gumbel_bwd": gumbel.gumbel_bwd,
            "gumbel_sharpen": gumbel.sharpen_gumbel_fused,
            "coupling": coupling.coupling_gram_fused,
            "recon_fwd": recon.fused_recon_mse,
            "recon_fwdbwd": recon.recon_fwdbwd,
            "recon_bwd": recon.recon_bwd,
            "encoder_fwd": encoder.encoder_fwd,
            "encoder_bwd": encoder.encoder_bwd,
            "zinb_fwd": zinb.fused_zinb,
            "zinb_fwdbwd": zinb.zinb_fwdbwd,
            "zinb_bwd": zinb.zinb_bwd}


def reset_launch_counts() -> None:
    for fn in _counted_wrappers().values():
        fn.launches = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build(check):
    from dvae_tpu_torch.ops import _build
    print("phase 1: build kernels")
    t0 = time.perf_counter()
    logs = _build.build(_build.KERNELS)
    for name in _build.KERNELS:
        _build.load(name)
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    check(True, f"built {list(_build.KERNELS)} in "
                f"{time.perf_counter() - t0:.1f} s")


def row_pass_value(torch, h, w, b, x, thr: float = 0.1):
    """(A, 2) sums of the value-only row pass of recon_passes.cuh on h, as
    #12 runs it on its h5 (``recon_rows_value_*`` of the recon_fwdbwd
    library, with its quiet copies in f32): the yardstick of #1.  Not a
    path of the port."""
    from dvae_tpu_torch.ops import recon as rc
    lib = rc._lib_fwdbwd()
    A_, B_, F_ = h.shape
    D_ = w.shape[2]
    f32 = h.dtype == torch.float32
    fn = lib.recon_rows_value_f32 if f32 else lib.recon_rows_value_bf16
    if not getattr(fn, "argtypes", None):
        fn.argtypes = rc._ARGTYPES + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    n_part = int(lib.recon_fwdbwd_partials_per_arm(A_, B_, D_))
    ps = torch.empty(A_ * n_part, device=h.device, dtype=torch.float32)
    pm = torch.empty(A_ * n_part, device=h.device, dtype=torch.int32)
    out = torch.empty((A_, 2), device=h.device, dtype=torch.float32)
    qws = rc._quiet_workspace(lib, A_, B_, F_, D_, h.dtype, h.device)
    err = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), x.data_ptr(),
             0 if x.dim() == 2 else B_ * D_, A_, B_, F_, D_, float(thr), 1,
             ps.data_ptr(), pm.data_ptr(), out.data_ptr(), qws.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"recon_rows_value failed: CUDA error {err}")
    return out


def recon_fwd_plan(torch, a, b, f, d, dtype) -> tuple:
    """#1's launch plan from its library: (k chunk, chunks, row blocks,
    column tiles, slices of D, column tiles a slice, stages, x staged,
    shared memory bytes)."""
    from dvae_tpu_torch.ops import recon as rc
    out = (ctypes.c_longlong * 9)()
    rcode = rc._lib().recon_fwd_plan(a, b, f, d,
                                     int(dtype == torch.bfloat16), out)
    return tuple(out) if rcode == 0 else None


def phase_kernels(torch, check) -> dict:
    """Kernel #1 vs its plain version; returns the record of the main case
    (f32, shared x, B=5000; bf16 under ``*_bf16``, the value-only row pass
    under ``row_pass_ms*``)."""
    from dvae_tpu_torch.ops.recon import fused_recon_mse, recon_mse_reference
    print("phase 2: recon_fwd kernel vs plain version")
    # the plan: the Python twin in tests/test_torch_recon.py gives the same
    for dtype, want in ((torch.float32,
                         (104, 1, 40, 79, 5, 16, 2, 0, 212992)),
                        (torch.bfloat16,
                         (112, 1, 40, 79, 5, 16, 4, 1, 159744))):
        got = recon_fwd_plan(torch, A, B, F, D, dtype)
        check(got == want, f"recon_fwd plan at (A, B, F, D) = ({A}, {B}, "
                           f"{F}, {D}), {dtype}: {got} (the twin's {want})")
    g = torch.Generator(device=DEV).manual_seed(SEED)
    g_grid = torch.Generator(device=DEV).manual_seed(SEED + 24)
    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for rows in (B, TAIL):
            for per_arm in (False, True):
                h, w, b, x = recon_inputs(torch, g, dtype, rows, per_arm)
                sk, mk = fused_recon_mse(h, w, b, x)
                sp, mp = recon_mse_reference(h, w, b, x)
                torch.cuda.synchronize()
                rel = ((sk - sp).abs() / sp.abs()).max().item()
                dm = (mk - mp).abs().max().item()
                sk2, mk2 = fused_recon_mse(h, w, b, x)
                same = bool(torch.equal(sk, sk2) and torch.equal(mk, mk2))
                tag = (f"{dname} B={rows} x={'per-arm' if per_arm else 'shared'}")
                check(rel <= TOL_SUMSQ[dname],
                      f"{tag}: sumsq max rel err {rel:.3e} "
                      f"(tol {TOL_SUMSQ[dname]:.0e})")
                check(dm <= TOL_MISM * rows * D,
                      f"{tag}: mism max abs diff {dm:.0f} "
                      f"(tol {TOL_MISM * rows * D:.0f} of {rows * D} elements)")
                check(same, f"{tag}: repeated launch bit-identical")
                if rows == B and not per_arm:
                    ms = cuda_ms(torch, lambda: fused_recon_mse(h, w, b, x))
                    dev_ms = device_ms(torch,
                                       lambda: fused_recon_mse(h, w, b, x))
                    rows_ms = cuda_ms(
                        torch, lambda: row_pass_value(torch, h, w, b, x))
                    plain = cuda_ms(torch,
                                    lambda: recon_mse_reference(h, w, b, x),
                                    iters=5)
                    bias3 = b[:, None, :]
                    lib = cuda_ms(torch,
                                  lambda: torch.baddbmm(bias3, h, w), iters=10)
                    bound, by = recon_bound_ms(A, rows, F, D, dname, per_arm)
                    tc_bound, tc_by = flops_bound_ms(
                        2.0 * A * rows * F * D,
                        recon_bound_bytes(A, rows, F, D, dname, per_arm),
                        dname, tensor_cores=True)
                    err = max((sk - sp).abs().max().item(), dm)
                    rp = row_pass_value(torch, h, w, b, x)
                    rp_rel = ((rp[:, 0] - sp).abs() / sp.abs()).max().item()
                    print(f"  {tag}: kernel_ms {ms:.4f} (device {dev_ms:.4f}) "
                          f"row_pass_ms {rows_ms:.4f} (its sumsq rel err "
                          f"{rp_rel:.1e}) plain_ms {plain:.4f} "
                          f"library_ms(baddbmm product) {lib:.4f} "
                          f"bound_ms {tc_bound:.4f} ({tc_by}, tensor cores) "
                          f"share_of_bound {tc_bound / ms:.3f}; FP32-core "
                          f"bound {bound:.4f} ({by})")
                    suffix = "" if dtype == torch.float32 else "_bf16"
                    if dtype == torch.float32:
                        record["max_abs_err"] = err
                    record.update({
                        f"ms{suffix}": ms, f"device_ms{suffix}": dev_ms,
                        f"row_pass_ms{suffix}": rows_ms,
                        f"plain_ms{suffix}": plain,
                        f"bound_ms{suffix}": tc_bound,
                        f"bound_by{suffix}": tc_by,
                        f"fp32_core_bound_ms{suffix}": bound,
                        f"library_ms{suffix}": lib})
                    check(ms < rows_ms,
                          f"{tag}: recon_fwd ({ms:.4f} ms) faster than the "
                          f"value-only row pass ({rows_ms:.4f} ms) on the "
                          "same inputs")
                del h, w, b, x
    # on the grid (h on 1/16, W on 1/256, b on 1/4096) y is exact in any
    # order of its sums: mism exact, sumsq within 1e-6; ragged F (37), F
    # past one resident chunk (160; bf16 448), rows of x and W that are
    # not 16-byte aligned (D = 5031)
    shapes = [(dt, rows, per_arm, f, d)
              for dt in (torch.float32, torch.bfloat16)
              for rows, per_arm, f, d in ((B, False, F, D), (B, True, F, D),
                                          (TAIL, False, F, 5031),
                                          (300, True, 37, 1000),
                                          (300, False, 160, 1000),
                                          (130, True, 448, 517))]
    for dtype, rows, per_arm, f, d in shapes:
        dname = str(dtype).split(".")[-1]
        tag = (f"{dname} B={rows} F={f} D={d} x="
               f"{'per-arm' if per_arm else 'shared'}, on the grid")
        ops = recon_inputs(torch, g_grid, dtype, rows, per_arm, True, f, d)
        sk, mk = fused_recon_mse(*ops)
        sp, mp = recon_mse_reference(*ops)
        rel = ((sk - sp).abs() / sp.abs()).max().item()
        again = fused_recon_mse(*ops)
        check(rel <= TOL_GRID_SUMSQ and torch.equal(mk, mp)
              and torch.equal(again[0], sk) and torch.equal(again[1], mk),
              f"{tag}: sumsq rel err {rel:.1e} (tol {TOL_GRID_SUMSQ:.0e}), "
              f"mism exact, repeats bit-identical (plan "
              f"{recon_fwd_plan(torch, A, rows, f, d, dtype)})")
        del ops, sk, mk, sp, mp, again
    # a NaN of one arm's h, W or x, either encoding, makes that arm's sumsq
    # NaN and leaves the other arms' sums bit for bit; a NaN of shared x
    # makes every arm's sumsq NaN
    others = [0, 2, 3, 4]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        view, nans = ((torch.int32, (0x7FFFFFFF, 0x7FC00000))
                      if dtype == torch.float32
                      else (torch.int16, (0x7FFF, 0x7FC0)))
        ops = recon_inputs(torch, g, dtype, TAIL, True)
        shared_x = ops[3][0].contiguous()
        clean = fused_recon_mse(*ops)
        clean_shared = fused_recon_mse(*ops[:3], shared_x)
        for bits in nans:
            for where, i, at in (("h", 0, (1, 7, 3)), ("W", 1, (1, 6, 42)),
                                 ("x", 3, (1, 11, 99))):
                bad = [t.clone() for t in ops]
                bad[i].view(view)[at] = bits
                got = fused_recon_mse(*bad)
                check(bool(torch.isnan(got[0][1])
                           and torch.equal(got[0][others], clean[0][others])
                           and torch.equal(got[1][others], clean[1][others])),
                      f"{dname} B={TAIL}: a NaN ({bits:#x}) in {where} of "
                      "arm 1 makes that arm's sumsq NaN and leaves the "
                      "other arms' sums bit for bit")
                del bad, got
            bad_x = shared_x.clone()
            bad_x.view(view)[11, 99] = bits
            got = fused_recon_mse(*ops[:3], bad_x)
            check(bool(torch.isnan(got[0]).all()
                       and torch.isfinite(clean_shared[0]).all()),
                  f"{dname} B={TAIL}: a NaN ({bits:#x}) in shared x makes "
                  "every arm's sumsq NaN")
            del bad_x, got
        del ops, shared_x, clean, clean_shared
    torch.cuda.empty_cache()
    return record


def phase_encoder(torch, check) -> dict:
    """Kernels #4/#5 vs their plain versions; returns the records of the
    main case (f32, shared x, B=5000, the mask drawn in the kernel)."""
    import numpy as np
    from dvae_tpu_torch.ops import encoder as enc
    print("phase 2: encoder_fwd / encoder_bwd kernels vs plain version")
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    # the in-kernel mask: bit for bit against its numpy version ...
    small = (A, 64, 203)
    km = enc.kernel_keep_mask(7, small, RATE, dev).cpu().numpy().astype(bool)
    check(bool(np.array_equal(km, enc.philox_keep_mask(7, small, RATE))),
          f"in-kernel Philox mask {small} equals its numpy version bit for bit")
    # ... its keep fraction over the A·B·D draws of one production step ...
    full = enc.kernel_keep_mask(7, (A, B, D), RATE, dev)
    n = full.numel()
    frac = full.sum(dtype=torch.int64).item() / n
    sigma = math.sqrt(RATE * (1 - RATE) / n)
    check(abs(frac - (1 - RATE)) <= 5 * sigma,
          f"keep fraction {frac:.6f} over {n} draws within 5 sigma "
          f"({5 * sigma:.1e}) of {1 - RATE}")
    # the Philox floor of any kernel that keeps these bits: the same device
    # function over the (A, B, D) draws of one forward, 126 MB of uint8 out
    floor_ms = cuda_ms(torch, lambda: enc.kernel_keep_mask(
        7, (A, B, D), RATE, dev), iters=10)
    n_calls = A * B * ((D + 3) // 4)
    print(f"  Philox floor: kernel_keep_mask over {(A, B, D)} "
          f"({n_calls:.3e} Philox4x32-10 calls) {floor_ms:.4f} ms; its "
          f"{n / 1e6:.0f} MB of output alone "
          f"{n / PEAK_BYTES_PER_S * 1e3:.4f} ms")
    del full
    # ... and forward/backward with it equal the plain version fed the
    # materialised mask
    xs = torch.relu(torch.randn((300, 203), generator=g, device=dev))
    ws = torch.randn((A, 203, F), generator=g, device=dev) * 0.05
    bs = torch.randn((A, F), generator=g, device=dev) * 0.05
    gs = torch.randn((A, 300, F), generator=g, device=dev)
    m = enc.kernel_keep_mask(7, (A, 300, 203), RATE, dev)
    e_y = rel_err(torch, enc.encoder_fwd(7, xs, ws, bs, RATE),
                  enc.dropout_fc1_reference(xs, ws, bs, RATE, m))
    dw, db = enc.encoder_bwd(7, xs, gs, RATE)
    dw0, db0 = enc.dropout_fc1_grad_reference(xs, gs, RATE, m)
    e_w = max(rel_err(torch, dw, dw0), rel_err(torch, db, db0))
    check(e_y <= TOL_REL["float32"] and e_w <= TOL_REL["float32"],
          f"in-kernel mask: forward rel err {e_y:.2e}, backward {e_w:.2e} "
          f"against the plain version fed that mask (tol 1e-05)")

    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        item = 4 if dtype == torch.float32 else 2
        for rows in (B, TAIL):
            for per_arm in (False, True):
                tag = f"{dname} B={rows} x={'per-arm' if per_arm else 'shared'}"
                shape = (A, rows, D) if per_arm else (rows, D)
                x = torch.relu(torch.randn(shape, generator=g, device=dev))
                w = torch.randn((A, D, F), generator=g, device=dev) * 0.02
                b = torch.randn((A, F), generator=g, device=dev) * 0.02
                gy = torch.randn((A, rows, F), generator=g, device=dev)
                x, w, b, gy = (t.to(dtype).contiguous() for t in (x, w, b, gy))
                mask = torch.rand((A, rows, D), generator=g,
                                  device=dev) < (1 - RATE)
                y = enc.encoder_fwd(11, x, w, b, RATE, mask)
                y0 = enc.dropout_fc1_reference(x, w, b, RATE, mask)
                tol_y = TOL_REL["float32"] if item == 4 else TOL_Y_BF16
                e_y = rel_err(torch, y, y0)
                check(y.dtype == dtype and e_y <= tol_y,
                      f"{tag}: encoder_fwd rel err {e_y:.2e} (tol {tol_y:.0e})")
                dw, db = enc.encoder_bwd(11, x, gy, RATE, mask)
                dw0, db0 = enc.dropout_fc1_grad_reference(x, gy, RATE, mask)
                e_w = max(rel_err(torch, dw, dw0), rel_err(torch, db, db0))
                # bf16 operands are exact in f32: only the order differs
                check(e_w <= TOL_REL["float32"],
                      f"{tag}: encoder_bwd rel err {e_w:.2e} (tol 1e-05)")
                y2 = enc.encoder_fwd(11, x, w, b, RATE, mask)
                dw2, db2 = enc.encoder_bwd(11, x, gy, RATE, mask)
                y3 = enc.encoder_fwd(11, x, w, b, RATE)
                dw3, _ = enc.encoder_bwd(11, x, gy, RATE)
                y4 = enc.encoder_fwd(11, x, w, b, RATE)
                dw4, _ = enc.encoder_bwd(11, x, gy, RATE)
                check(bool(torch.equal(y, y2) and torch.equal(dw, dw2)
                           and torch.equal(db, db2) and torch.equal(y3, y4)
                           and torch.equal(dw3, dw4)),
                      f"{tag}: repeated launches bit-identical (explicit "
                      "and in-kernel mask)")
                if rows == B and not per_arm:
                    # timed as the training step runs them: mask in-kernel
                    f_ms = cuda_ms(torch, lambda: enc.encoder_fwd(
                        11, x, w, b, RATE))
                    b_ms = cuda_ms(torch, lambda: enc.encoder_bwd(
                        11, x, gy, RATE))
                    f_plain = plain_ms(torch, lambda: enc.dropout_fc1_reference(
                        x, w, b, RATE, mask))
                    b_plain = plain_ms(torch,
                                       lambda: enc.dropout_fc1_grad_reference(
                                           x, gy, RATE, mask))
                    f_lib = cuda_ms(torch, lambda: torch.matmul(x, w),
                                    iters=10)
                    xt = x.t()
                    b_lib = cuda_ms(torch, lambda: torch.matmul(xt, gy),
                                    iters=10)
                    flops = 2.0 * A * rows * D * F
                    f_bound = flops_bound_ms(
                        flops, (rows * D + A * D * F + A * F + A * rows * F)
                        * item, dname, tensor_cores=True)
                    b_bound = flops_bound_ms(
                        flops, (rows * D + A * rows * F) * item
                        + (A * D * F + A * F) * 4, dname, tensor_cores=True)
                    for name, ms, pl, lib, (bound, by), err in (
                            ("encoder_fwd", f_ms, f_plain, f_lib, f_bound,
                             (y.float() - y0.float()).abs().max().item()),
                            ("encoder_bwd", b_ms, b_plain, b_lib, b_bound,
                             max((dw - dw0).abs().max().item(),
                                 (db - db0).abs().max().item()))):
                        print(f"  {tag}: {name} kernel_ms {ms:.4f} plain_ms "
                              f"{pl:.4f} library_ms(matmul product) "
                              f"{lib:.4f} bound_ms {bound:.4f} ({by}) "
                              f"share_of_bound {bound / ms:.3f}")
                        if item == 4:
                            records[name] = {
                                "max_abs_err": err, "ms": ms, "plain_ms": pl,
                                "bound_ms": bound, "bound_by": by,
                                "library_ms": lib}
                    # the forward without the mask (rate 0: identity) and
                    # with the explicit one, beside the in-kernel draw
                    i_ms = cuda_ms(torch, lambda: enc.encoder_fwd(
                        11, x, w, b, 0.0))
                    m_ms = cuda_ms(torch, lambda: enc.encoder_fwd(
                        11, x, w, b, RATE, mask))
                    print(f"  {tag}: encoder_fwd identity mask {i_ms:.4f} ms, "
                          f"explicit mask {m_ms:.4f} ms, in-kernel Philox "
                          f"{f_ms:.4f} ms; fp32-core bound "
                          f"{flops / PEAK_FLOPS['float32'] * 1e3:.4f} ms")
                    i_ms = cuda_ms(torch, lambda: enc.encoder_bwd(
                        11, x, gy, 0.0))
                    m_ms = cuda_ms(torch, lambda: enc.encoder_bwd(
                        11, x, gy, RATE, mask))
                    print(f"  {tag}: encoder_bwd identity mask {i_ms:.4f} ms, "
                          f"explicit mask {m_ms:.4f} ms, in-kernel Philox "
                          f"{b_ms:.4f} ms")
                del x, w, b, gy, mask, y, y0, dw, dw0
    torch.cuda.empty_cache()
    return records


def recon_inputs(torch, g, dtype, rows, per_arm, on_grid=False, f=None,
                 d=None):
    """Operands of #2 and #3: h in [0, 1), W and bias in ±0.1, x = relu of
    a normal draw.  ``on_grid``: h on multiples of 1/16, W on 1/256 and the
    bias on 1/4096, so that every sum of y is exact in f32 whatever its
    order (and h and W have no low tf32 half).  Off the grid gm jumps by
    2x at the ReLU kink (gm = 0 for y <= 0, 2 (y - x) just above), so two
    correct products summed in another order can differ in dh, dW and db
    at an element whose y lies within rounding of 0.  ``f``, ``d``: other
    widths than the production F and D."""
    dev = DEV
    f, d = f or F, d or D
    h = torch.rand((A, rows, f), generator=g, device=dev)
    w = (torch.rand((A, f, d), generator=g, device=dev) - 0.5) * 0.2
    b = (torch.rand((A, d), generator=g, device=dev) - 0.5) * 0.2
    shape = (A, rows, d) if per_arm else (rows, d)
    x = torch.relu(torch.randn(shape, generator=g, device=dev))
    if on_grid:
        h = torch.floor(h * 16.0) / 16.0
        w = torch.round(w * 256.0) / 256.0
        b = torch.round(b * 4096.0) / 4096.0
    return [t.to(dtype).contiguous() for t in (h, w, b, x)]


def recon_nearest_kink(torch, h, w, b, x, got, want) -> str:
    """Where #2's or #3's gradients move most against the plain version:
    the (arm, column) of the largest |Δdb| and the (arm, row) of the
    largest |Δdh|, with the plain version's |y| (f32 baddbmm, as
    ``recon_fwdbwd_reference`` takes it) at that element, and the draw's
    least |y| over all elements."""
    ddb = (got[2] - want[2]).abs()
    ddh = (got[0] - want[0]).abs().amax(dim=2)
    a_c, col = divmod(int(ddb.argmax()), ddb.shape[1])
    y_col = torch.addmm(b[a_c].float()[None, :], h[a_c].float(),
                        w[a_c].float())[:, col]
    out = (f"largest |Δdb| at arm {a_c} column {col}: min |y| over its "
           f"rows {y_col.abs().min().item():.1e}; ")
    if ddh.max().item() > 0:
        a_r, row = divmod(int(ddh.argmax()), ddh.shape[1])
        y_row = torch.addmm(b[a_r].float()[None, :],
                            h[a_r, row:row + 1].float(), w[a_r].float())[0]
        out += (f"largest |Δdh| at arm {a_r} row {row}: min |y| over its "
                f"columns {y_row.abs().min().item():.1e}; ")
    least = min(torch.baddbmm(b[i:i + 1].float()[:, None, :],
                              h[i:i + 1].float(), w[i:i + 1].float())
                .abs().min().item() for i in range(h.shape[0]))
    return out + f"the draw's least |y| {least:.1e}"


def recon_clear_of_kink(torch, h, w, b):
    """(rows (A, B), columns (A, D)) of each arm on which every |y| of the
    plain version (f32 addmm, as ``recon_fwdbwd_reference`` takes it)
    exceeds KINK_Y: the rows of dh and the columns of dW and db that no
    flip of gm at the ReLU kink can reach."""
    rows = torch.empty(h.shape[:2], dtype=torch.bool, device=h.device)
    cols = torch.empty((h.shape[0], w.shape[2]), dtype=torch.bool,
                       device=h.device)
    for i in range(h.shape[0]):
        far = torch.addmm(b[i].float()[None, :], h[i].float(),
                          w[i].float()).abs() > KINK_Y
        rows[i], cols[i] = far.all(dim=1), far.all(dim=0)
        del far
    return rows, cols


def recon_held_errs(torch, got, want, rows=None, cols=None):
    """max |Δ| / max |plain| of the gradients (dh, dW, db; or dW, db when
    ``rows`` is None) where the kink cannot reach them: dh on ``rows``,
    dW and db on ``cols``.  A NaN or an infinity anywhere propagates."""
    diffs = ([(got[0].float() - want[0].float()).abs().amax(dim=2) * rows]
             if rows is not None else [])
    dw, db = (got[-2].float() - want[-2].float()).abs(), \
        (got[-1].float() - want[-1].float()).abs()
    diffs += [dw.amax(dim=1) * cols, db * cols]
    return [(d.max() / e.float().abs().max().clamp_min(1e-30)).item()
            for d, e in zip(diffs, want[-len(diffs):])]


def time_recon(torch, g, name, kern, plain, h, w, b, x, dname, item, tag,
               out_bytes, record):
    """Times of #2 or #3 at the main shape beside the plain version, the
    library's three products (on a cotangent drawn from ``g``) and the
    bounds (tensor cores and FP32 cores); the passes on the device.  Adds
    them to ``record`` (f32 under the common keys, bf16 under ``*_bf16``)."""
    rows = h.shape[1]
    ms = cuda_ms(torch, kern)
    pl = plain_ms(torch, plain)
    gm = torch.randn((A, rows, D), generator=g, device=DEV).to(h.dtype)
    bias3, wt, ht = b[:, None, :], w.transpose(1, 2), h.transpose(1, 2)
    lib = cuda_ms(torch, lambda: (
        torch.baddbmm(bias3, h, w), torch.bmm(gm, wt), torch.bmm(ht, gm)),
        iters=10)
    del gm
    nbytes = ((A * rows * F + A * F * D + A * D + rows * D) * item
              + out_bytes)
    flops = 6.0 * A * rows * F * D
    bound, by = flops_bound_ms(flops, nbytes, dname, tensor_cores=True)
    simt, _ = flops_bound_ms(flops, nbytes, "float32")
    parts = kernel_device_ms(torch, kern)
    split = {m.group(0): v for k, v in parts.items()
             if (m := re.search(r"(recon|quiet)_[a-z_]+", k))}
    dev_ms = sum(split.values())
    print(f"  {tag}: {name} device ms by kernel: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(split.items()))
        + f"; total {dev_ms:.4f}")
    print(f"  {tag}: {name} kernel_ms {ms:.4f} plain_ms {pl:.4f} "
          f"library_ms(three products) {lib:.4f} bound_ms {bound:.4f} ({by}) "
          f"share_of_bound {bound / ms:.3f}; FP32-core bound {simt:.4f}")
    suffix = "" if item == 4 else "_bf16"
    record.update({f"ms{suffix}": ms, f"plain_ms{suffix}": pl,
                   f"bound_ms{suffix}": bound, f"bound_by{suffix}": by,
                   f"library_ms{suffix}": lib,
                   f"device_ms_by_pass{suffix}": {k: round(v, 4)
                                          for k, v in split.items()}})


def nan_of_x_cases(torch, y, per_arm, dtype):
    """Where fault C5's checks put a NaN of x, from the plain y (A, B, D),
    exact on the grid draws: (what, index into x, bits).  Arm 1's r > 0
    (gm NaN there), with both NaN encodings, the card's own and the quiet
    one; arm 1's r = 0 (per-arm x) or every arm's r = 0 (shared x): gm 0,
    only sums NaN."""
    bits = ((0x7FFFFFFF, 0x7FC00000) if dtype == torch.float32
            else (0x7FFF, 0x7FC0))
    live = torch.nonzero(y[1] > 0)[0].tolist()
    dead = torch.nonzero((y[1] if per_arm else y.amax(dim=0)) <= 0)[0]
    dead = dead.tolist()
    where = (lambda i, j: (1, i, j)) if per_arm else (lambda i, j: (i, j))
    return ([(f"arm 1's r > 0 ({v:#x})", where(*live), v) for v in bits]
            + [("r = 0 in " + ("arm 1" if per_arm else "every arm")
                + f" ({bits[0]:#x})", where(*dead), bits[0])])


def hold_nan_pattern(torch, got, want, clean) -> bool:
    """Each output of the kernel NaN exactly where the plain version's is
    (fault C5's pattern, held to the JAX kernel by the CPU tests), and
    every other element bit for bit the clean input's."""
    for u, v, c in zip(got, want, clean):
        m = torch.isnan(u)
        if not (torch.equal(m, torch.isnan(v)) and torch.equal(u[~m], c[~m])):
            return False
    return True


def phase_recon_fwdbwd(torch, check) -> dict:
    """Kernel #2 vs its plain version; returns the record of the main
    case (f32, shared x, B=5000; bf16 under ``*_bf16``).  Each case runs
    on the uniform draw and on a draw on the grid of ``recon_inputs``."""
    from dvae_tpu_torch.ops import recon as rc
    from dvae_tpu_torch.ops.recon import recon_fwdbwd, recon_fwdbwd_reference
    print("phase 2: recon_fwdbwd kernel vs plain version")
    # the row plan of the CUDA source: its rules, and at the two training
    # shapes the plan that the CPU tests derive from its Python twin
    lib = rc._lib_fwdbwd()
    plans = {}
    for s in [(A, B, D), (A, TAIL, D), (3, 16, 40), (3, 520, 40), (1, 1, 1),
              (2, 70000, 5032), (7, 333, 12345)]:
        out = (ctypes.c_int * 3)()
        rcode = lib.recon_fwdbwd_plan(*s, out)
        n, cols, tiles = plans[s] = tuple(out)
        check(rcode == 0 and tiles == -(-s[1] // 64) and cols % 32 == 0
              and 1 <= n <= 8 and n - 1 <= s[2] // s[1]
              and (n - 1) * cols < s[2] <= n * cols
              and lib.recon_fwdbwd_partials_per_arm(*s) == n * tiles,
              f"recon_fwdbwd row plan at (A, B, D) = {s}: {n} slices of "
              f"{cols} columns, {tiles} row tiles: whole steps that cover D "
              "once, partials per arm = slices x row tiles")
    check(plans[(A, B, D)] == (2, 2528, 79)
          and plans[(A, TAIL, D)] == (3, 1696, 32),
          f"recon_fwdbwd row plan at B={B}, {TAIL}: "
          f"{plans[(A, B, D)]}, {plans[(A, TAIL, D)]} (the Python twin's "
          "(2, 2528, 79), (3, 1696, 32))")
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    g_grid = torch.Generator(device=dev).manual_seed(SEED + 20)
    record = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        item = 4 if dtype == torch.float32 else 2
        for rows in (B, TAIL):
            for per_arm in (False, True):
                for on_grid in (False, True):
                    tag = (f"{dname} B={rows} x="
                           f"{'per-arm' if per_arm else 'shared'}"
                           + (", on the grid" if on_grid else ""))
                    h, w, b, x = recon_inputs(torch, g_grid if on_grid else g,
                                              dtype, rows, per_arm, on_grid)
                    got = recon_fwdbwd(h, w, b, x)
                    want = recon_fwdbwd_reference(h, w, b, x)
                    torch.cuda.synchronize()
                    rel = ((got[0] - want[0]).abs()
                           / want[0].abs()).max().item()
                    dm = (got[1] - want[1]).abs().max().item()
                    check(rel <= TOL_SUMSQ[dname],
                          f"{tag}: sumsq max rel err {rel:.3e} "
                          f"(tol {TOL_SUMSQ[dname]:.0e})")
                    check(dm <= TOL_MISM * rows * D,
                          f"{tag}: mism max abs diff {dm:.0f} "
                          f"(tol {TOL_MISM * rows * D:.0f})")
                    errs = [rel_err(torch, a, e)
                            for a, e in zip(got[2:], want[2:])]
                    listed = "/".join(f"{e:.2e}" for e in errs)
                    if on_grid:
                        check(max(errs) <= TOL_REL[dname],
                              f"{tag}: dh/dW/db rel err {listed} "
                              f"(tol {TOL_REL[dname]:.0e})")
                    else:
                        rk, ck = recon_clear_of_kink(torch, h, w, b)
                        held = recon_held_errs(torch, got[2:], want[2:],
                                               rk, ck)
                        check(max(held) <= TOL_REL[dname],
                              f"{tag}: dh on the {rk.float().mean():.4f} "
                              f"of rows, dW/db on the {ck.float().mean():.4f}"
                              " of columns with every plain |y| > "
                              f"{KINK_Y:.0e}: rel err " + "/".join(f"{e:.2e}" for e in held)
                              + f" (tol {TOL_REL[dname]:.0e}); over all "
                              f"{listed} (a reading: "
                              + recon_nearest_kink(torch, h, w, b, x,
                                                   got[2:], want[2:]) + ")")
                    again = recon_fwdbwd(h, w, b, x)
                    check(all(torch.equal(u, v) for u, v in zip(got, again)),
                          f"{tag}: repeated launch bit-identical")
                    if item == 4:  # over the outputs held
                        record["max_abs_err"] = max(
                            [record["max_abs_err"],
                             abs(got[0] - want[0]).max().item(), dm]
                            + ([(a - e).abs().max().item()
                                for a, e in zip(got[2:], want[2:])]
                               if on_grid else
                               [e * v.abs().max().item()
                                for e, v in zip(held, want[2:])]))
                    if rows == B and not per_arm and not on_grid:
                        time_recon(
                            torch, g, "recon_fwdbwd",
                            lambda: recon_fwdbwd(h, w, b, x),
                            lambda: recon_fwdbwd_reference(h, w, b, x),
                            h, w, b, x, dname, item, tag,
                            (A * 2 + A * rows * F + A * F * D + A * D) * 4,
                            record)
                    del h, w, b, x, got, want, again
    # other widths on the grid: F = 128 and 105 (the wider template), an
    # odd D whose rows allow no 16-byte chunk, ragged rows
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for rows, f, d in ((300, 128, 1000), (130, 105, 517), (77, 24, 333)):
            tag = f"{dname} B={rows} F={f} D={d}, on the grid"
            ops = recon_inputs(torch, g_grid, dtype, rows, True, True, f, d)
            got = recon_fwdbwd(*ops)
            want = recon_fwdbwd_reference(*ops)
            rel = ((got[0] - want[0]).abs() / want[0].abs()).max().item()
            errs = [rel_err(torch, a, e) for a, e in zip(got[2:], want[2:])]
            check(rel <= TOL_SUMSQ[dname] and max(errs) <= TOL_REL[dname]
                  and torch.equal(got[1], want[1]),
                  f"{tag}: sumsq rel err {rel:.1e}, mism exact, dh/dW/db rel "
                  "err " + "/".join(f"{e:.1e}" for e in errs)
                  + f" (tol {TOL_SUMSQ[dname]:.0e}, {TOL_REL[dname]:.0e})")
            del ops, got, want
    # a NaN in h or W of one arm reaches that arm only, whatever its bits:
    # the quiet NaN and the card's own (0x7FFFFFFF), which the split of
    # the f32 products would turn into -0 (csrc/recon_passes.cuh
    # quiet_copy)
    ops = recon_inputs(torch, g, torch.float32, TAIL, False)
    clean = recon_fwdbwd(*ops)
    others = [0, 2, 3, 4]
    for where, i, at, bits in (("h", 0, (1, 7, 3), 0x7FC00000),
                               ("h", 0, (1, 7, 3), 0x7FFFFFFF),
                               ("W", 1, (1, 6, 42), 0x7FFFFFFF)):
        bad = [t.clone() for t in ops]
        bad[i].view(torch.int32)[at] = bits
        got = recon_fwdbwd(*bad)
        check(bool(torch.isnan(got[0][1])
                   and any(torch.isnan(t[1]).any() for t in got[2:4])
                   and all(torch.equal(u[others], v[others])
                           for u, v in zip(got, clean))),
              f"float32 B={TAIL}: a NaN ({bits:#x}) in {where} of arm 1 "
              "makes that arm's sumsq and some of its gradients NaN and "
              "leaves the other arms' outputs bit for bit")
        del bad, got
    del ops, clean
    # fault C5: a NaN of x, either encoding, where arm 1's r > 0 makes gm
    # NaN there: the plain version's NaN pattern (that arm's dh row, dW
    # column and db entry, the sums of every arm that reads it), every
    # other element bit for bit; where r = 0 only the sums (#2, and #3 at
    # cotangent 1.5); on the grid draws, where y is exact in any order
    from dvae_tpu_torch.ops.recon import recon_bwd, recon_bwd_reference
    cot = torch.full((A,), 1.5, device=dev)
    for dtype, per_arm in itertools.product((torch.float32, torch.bfloat16),
                                            (True, False)):
        dname = str(dtype).split(".")[-1]
        view = torch.int32 if dtype == torch.float32 else torch.int16
        ops = recon_inputs(torch, g_grid, dtype, TAIL, per_arm, True)
        y = torch.baddbmm(ops[2].float()[:, None, :], ops[0].float(),
                          ops[1].float())
        clean = recon_fwdbwd(*ops)
        clean3 = recon_bwd(cot, *ops)
        for what, at, bits in nan_of_x_cases(torch, y, per_arm, dtype):
            bad = list(ops[:3]) + [ops[3].clone()]
            bad[3].view(view)[at] = bits
            got, want = recon_fwdbwd(*bad), recon_fwdbwd_reference(*bad)
            g3, w3 = recon_bwd(cot, *bad), recon_bwd_reference(cot, *bad)
            reads = torch.isnan(want[0])
            n_dh = int(torch.isnan(got[2]).any(dim=2).sum())
            check(hold_nan_pattern(torch, [got[0], *got[2:]],
                                   [want[0], *want[2:]],
                                   [clean[0], *clean[2:]])
                  and torch.equal(got[1][~reads], clean[1][~reads])
                  and hold_nan_pattern(torch, g3, w3, clean3)
                  and (n_dh > 0) == ("r > 0" in what),
                  f"{dname} B={TAIL} x={'per-arm' if per_arm else 'shared'}"
                  f", on the grid: a NaN of x where {what}: recon_fwdbwd "
                  "and recon_bwd NaN where the plain version is (sums of "
                  f"{int(reads.sum())} arms, {n_dh} dh rows, "
                  f"{int(torch.isnan(got[4]).sum())} db entries), every "
                  "other element bit for bit the clean input's")
            del bad, got, want, g3, w3
        del ops, y, clean, clean3
    torch.cuda.empty_cache()
    return record


def phase_recon_bwd(torch, check) -> dict:
    """Kernel #3 (the separate recon backward) vs its plain version and vs
    the fused kernel's unscaled gradients; returns the record of the main
    case (f32, shared x, B=5000; bf16 under ``*_bf16``).  Each case runs on
    the uniform draw and on a draw on the grid of ``recon_inputs``."""
    from dvae_tpu_torch.ops.recon import (recon_bwd, recon_bwd_reference,
                                          recon_fwdbwd)
    print("phase 2: recon_bwd kernel vs plain version")
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    g_grid = torch.Generator(device=dev).manual_seed(SEED + 21)
    record = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        item = 4 if dtype == torch.float32 else 2
        for rows in (B, TAIL):
            for per_arm in (False, True):
                for on_grid in (False, True):
                    tag = (f"{dname} B={rows} x="
                           f"{'per-arm' if per_arm else 'shared'}"
                           + (", on the grid" if on_grid else ""))
                    h, w, b, x = recon_inputs(torch, g_grid if on_grid else g,
                                              dtype, rows, per_arm, on_grid)
                    cot = torch.linspace(-1.5, 2.5, A, device=dev)
                    got = recon_bwd(cot, h, w, b, x)
                    want = recon_bwd_reference(cot, h, w, b, x)
                    torch.cuda.synchronize()
                    errs = [rel_err(torch, a, e) for a, e in zip(got, want)]
                    listed = "/".join(f"{e:.2e}" for e in errs)
                    if on_grid:
                        check(max(errs) <= TOL_REL[dname],
                              f"{tag}: recon_bwd(g) dh/dW/db rel err "
                              f"{listed} (tol {TOL_REL[dname]:.0e})")
                    else:
                        rk, ck = recon_clear_of_kink(torch, h, w, b)
                        held = recon_held_errs(torch, got, want, rk, ck)
                        check(max(held) <= TOL_REL[dname],
                              f"{tag}: recon_bwd(g) dh on the "
                              f"{rk.float().mean():.4f} of rows, dW/db on the "
                              f"{ck.float().mean():.4f} of columns with every "
                              f"plain |y| > {KINK_Y:.0e}: rel err "
                              + "/".join(f"{e:.2e}" for e in held)
                              + f" (tol {TOL_REL[dname]:.0e}); over all "
                              f"{listed} (a reading: "
                              + recon_nearest_kink(torch, h, w, b, x, got,
                                                   want) + ")")
                    ones = recon_bwd(torch.ones(A, device=dev), h, w, b, x)
                    fused = recon_fwdbwd(h, w, b, x)[2:]
                    check(all(torch.equal(u, v) for u, v in zip(ones, fused)),
                          f"{tag}: recon_bwd(ones) equals recon_fwdbwd's "
                          "gradients bit for bit")
                    again = recon_bwd(cot, h, w, b, x)
                    check(all(torch.equal(u, v) for u, v in zip(got, again)),
                          f"{tag}: repeated launch bit-identical")
                    if item == 4:  # the outputs held
                        record["max_abs_err"] = max(
                            [record["max_abs_err"]]
                            + ([(a - e).abs().max().item()
                                for a, e in zip(got, want)] if on_grid else
                               [e * v.abs().max().item()
                                for e, v in zip(held, want)]))
                    if rows == B and not per_arm and not on_grid:
                        time_recon(
                            torch, g, "recon_bwd",
                            lambda: recon_bwd(cot, h, w, b, x),
                            lambda: recon_bwd_reference(cot, h, w, b, x),
                            h, w, b, x, dname, item, tag,
                            (A + A * rows * F + A * F * D + A * D) * 4,
                            record)
                    del h, w, b, x, got, want, again, ones, fused
    torch.cuda.empty_cache()
    return record


def zinb_inputs(torch, g, dtype, rows, per_arm, huge=False, on_grid=False,
                f=None):
    """Operands of the ZINB kernels that hit the hard places: a non-negative
    hidden with every 97th row zero (there y = bias, half of them <= 0),
    pre-activations of both signs, half of x exactly zero, x up to X_MAX,
    and with ``huge`` one column whose counts pass P4's f32 overflow.

    ``on_grid``: h on multiples of 1/16 and the rate head's weights and
    bias on multiples of 1/256 and 1/4096, so that every sum of y_r is
    exact in f32 whatever its order.  Off the grid the rate cotangent
    jumps at the ReLU kink (g_r = 0 for y_r <= 0, up to −1/eps just
    above), so two correct f32 products summed in another order, which
    differ in y_r's last bits, differ in dh, dW_r and db_r by as much as
    the one element of the draw whose y_r lies nearest 0 (x > 0) makes
    them; the other outputs do not see the jump.  On the grid h's low
    tf32 half is zero, so only off the grid does the 3xTF32 split of h
    show in the products.  ``f``: another hidden width than F."""
    dev = DEV
    f = f or F
    h = torch.rand((A, rows, f), generator=g, device=dev)
    if on_grid:
        h = torch.floor(h * 16.0) / 16.0
    h[:, ::97] = 0.0
    heads = []
    for i in range(3):
        w = (torch.rand((A, f, D), generator=g, device=dev) - 0.5) * 0.2
        b = (torch.rand((A, D), generator=g, device=dev) - 0.5) * 0.2
        if on_grid and i == 0:
            w = torch.round(w * 256.0) / 256.0
            b = torch.round(b * 4096.0) / 4096.0
        heads += [w, b]
    shape = (A, rows, D) if per_arm else (rows, D)
    x = torch.relu(torch.randn(shape, generator=g, device=dev) * 2.0 + 0.5)
    x = x * (torch.rand(shape, generator=g, device=dev) > 0.5)
    x[..., ::53, 3] = X_MAX
    if huge:
        x[..., 7] = X_HUGE
    return [t.to(dtype).contiguous() for t in (h, *heads, x)]


# outputs of flat(zinb_fwdbwd(...)[1:]) that the rate cotangent's jump at
# the ReLU kink reaches: dh, dW_r, db_r
ZINB_AT_KINK = (0, 1, 2)
ZINB_GRAD_NAMES = ("dh", "dW_r", "db_r", "dW_p", "db_p", "dW_z", "db_z")


def rate_nearest_kink(torch, h, w_r, b_r, x) -> float:
    """min |y_r| over the elements with x > 0, y_r taken in f64 from the
    operands: how close the draw comes to the rate cotangent's jump."""
    best = math.inf
    for a in range(h.shape[0]):
        y = torch.addmm(b_r[a].double()[None, :], h[a].double(),
                        w_r[a].double())
        xa = x[a] if x.dim() == 3 else x
        best = min(best, y.abs()[xa > 0].min().item())
        del y
    return best


def phase_zinb(torch, check) -> dict:
    """Kernels #6, #7, #8 vs their plain versions; returns the records of
    the main case (f32, shared x, B=5000)."""
    from dvae_tpu_torch.ops import zinb
    print("phase 2: zinb_fwd / zinb_fwdbwd / zinb_bwd kernels vs plain "
          "version")
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    records = {}

    def flat(out):
        return [out[0], *out[1], *out[2], *out[3]]

    def rel_errs(got, want):
        return [rel_err(torch, a, e) for a, e in zip(got, want)]

    def listed(errs, idx):
        return "/".join(f"{ZINB_GRAD_NAMES[i]} {errs[i]:.1e}" for i in idx)

    cases = [(dt, rows, pa, False) for dt in (torch.float32, torch.bfloat16)
             for rows in (B, TAIL) for pa in (False, True)]
    cases += [(dt, TAIL, False, True)
              for dt in (torch.float32, torch.bfloat16)]
    for dtype, rows, per_arm, huge in cases:
        dname = str(dtype).split(".")[-1]
        item = 4 if dtype == torch.float32 else 2
        cot = torch.linspace(-1.5, 2.5, A, device=dev)
        tol_g = TOL_ZINB_GRAD[dname]
        max_abs = {"zinb_fwd": 0.0, "zinb_fwdbwd": 0.0, "zinb_bwd": 0.0}
        # on the grid every output is held; off it, every output but the
        # three the kink reaches, and those are printed beside the draw's
        # nearest approach to the kink
        for on_grid in (True, False):
            tag = (f"{dname} B={rows} x={'per-arm' if per_arm else 'shared'}"
                   + (" counts>=5e9 column" if huge else "")
                   + (", on the grid" if on_grid else ", off the grid"))
            held = (range(7) if on_grid
                    else [i for i in range(7) if i not in ZINB_AT_KINK])
            ops = zinb_inputs(torch, g, dtype, rows, per_arm, huge, on_grid)
            h, x = ops[0], ops[7]
            heads = tuple(zip(ops[1:7:2], ops[2:7:2]))

            v = zinb.fused_zinb(*ops, ZINB_EPS)
            v0 = zinb.zinb_heads_plain(*ops, ZINB_EPS)
            fb = zinb.zinb_fwdbwd(*ops, ZINB_EPS)
            fb0 = zinb.zinb_grads_plain(*ops, ZINB_EPS)
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(t).all())
                         for t in (v, fb[0], *flat(fb[1:])))
            check(finite, f"{tag}: loss and gradients finite")
            e_v = ((v - v0).abs() / v0.abs()).max().item()
            e_l = ((fb[0] - fb0[0]).abs() / fb0[0].abs()).max().item()
            check(e_v <= TOL_ZINB_LOSS and e_l <= TOL_ZINB_LOSS,
                  f"{tag}: loss max rel err zinb_fwd {e_v:.3e}, zinb_fwdbwd "
                  f"{e_l:.3e} (tol {TOL_ZINB_LOSS:.0e})")
            # one row pass, one plan and one reduction: the same bits
            check(bool(torch.equal(v, fb[0])),
                  f"{tag}: zinb_fwd's value equals zinb_fwdbwd's loss bit "
                  f"for bit (max |diff| {(v - fb[0]).abs().max().item():.1e})")
            errs = rel_errs(flat(fb[1:]), flat(fb0[1:]))
            check(max(errs[i] for i in held) <= tol_g,
                  f"{tag}: zinb_fwdbwd rel err {listed(errs, held)} "
                  f"(tol {tol_g:.0e})")
            if not on_grid:
                near = rate_nearest_kink(torch, h, ops[1], ops[2], x)
                print(f"  {tag}: zinb_fwdbwd rel err "
                      f"{listed(errs, ZINB_AT_KINK)} (a reading: the draw's "
                      f"y_r nearest the kink at x > 0 is {near:.1e}, "
                      f"eps {ZINB_EPS:.0e})")
            flat_fb, flat_fb0 = flat(fb[1:]), flat(fb0[1:])
            max_abs["zinb_fwd"] = max(max_abs["zinb_fwd"],
                                      (v - v0).abs().max().item())
            max_abs["zinb_fwdbwd"] = max(
                [max_abs["zinb_fwdbwd"], (fb[0] - fb0[0]).abs().max().item()]
                + [(flat_fb[i] - flat_fb0[i]).abs().max().item()
                   for i in held])
            del fb0, flat_fb0
            # kernel against kernel: both compute y_r the same way, so the
            # kink moves neither and every output is held
            ones = zinb.zinb_bwd(torch.ones(A, device=dev), h, heads, x,
                                 ZINB_EPS)
            errs = rel_errs(flat(ones), flat_fb)
            check(max(errs) <= tol_g,
                  f"{tag}: zinb_bwd(ones) vs zinb_fwdbwd's gradients rel err "
                  f"{max(errs):.1e} (tol {tol_g:.0e}: two digamma calls "
                  "against their shared difference)")
            del ones, flat_fb
            bw = zinb.zinb_bwd(cot, h, heads, x, ZINB_EPS)
            bw0 = zinb.zinb_bwd_plain(cot, h, heads, x, ZINB_EPS)
            errs = rel_errs(flat(bw), flat(bw0))
            check(max(errs[i] for i in held) <= tol_g,
                  f"{tag}: zinb_bwd(g) rel err {listed(errs, held)} "
                  f"(tol {tol_g:.0e})")
            max_abs["zinb_bwd"] = max(
                [max_abs["zinb_bwd"]]
                + [(a - e).abs().max().item()
                   for i, (a, e) in enumerate(zip(flat(bw), flat(bw0)))
                   if i in held])
            del bw0
            v2 = zinb.fused_zinb(*ops, ZINB_EPS)
            fb2 = zinb.zinb_fwdbwd(*ops, ZINB_EPS)
            bw2 = zinb.zinb_bwd(cot, h, heads, x, ZINB_EPS)
            check(bool(torch.equal(v, v2) and torch.equal(fb[0], fb2[0])
                       and all(torch.equal(a, e) for a, e in zip(
                           flat(fb[1:]) + flat(bw),
                           flat(fb2[1:]) + flat(bw2)))),
                  f"{tag}: repeated launches of the three kernels "
                  "bit-identical")
            del fb2, bw2, v2
            if rows == B and not per_arm and not huge and not on_grid:
                time_zinb(torch, zinb, ops, cot, dname, item, tag, max_abs,
                          records)
            del ops, h, x, heads, v, v0, fb, bw
            torch.cuda.empty_cache()
    return records


def time_zinb(torch, zinb, ops, cot, dname, item, tag, max_abs, records):
    """Times of #6, #7 and #8 at the main shape beside their plain
    versions, the library's products and the bound; #7's and #8's kernels
    on the device; the element math's share (f32)."""
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    rows = B
    h, x = ops[0], ops[7]
    heads = tuple(zip(ops[1:7:2], ops[2:7:2]))
    x_elems = rows * D
    in_bytes = (A * rows * F + 3 * A * F * D + 3 * A * D + x_elems) * item
    grad_bytes = (A * rows * F + 3 * A * F * D + 3 * A * D) * 4
    prod = 2.0 * A * rows * F * D
    gm = torch.randn((A, rows, D), generator=g, device=dev).to(h.dtype)
    hT = h.transpose(1, 2)

    def lib_fwd():
        return [torch.baddbmm(b[:, None, :], h, w) for w, b in heads]

    def lib_nine():
        return (lib_fwd(),
                [torch.bmm(gm, w.transpose(1, 2)) for w, _ in heads],
                [torch.bmm(hT, gm) for _ in heads])

    lib3 = cuda_ms(torch, lib_fwd, iters=10)
    lib9 = cuda_ms(torch, lib_nine, iters=10)
    del gm
    timed = (
        ("zinb_fwd", lambda: zinb.fused_zinb(*ops, ZINB_EPS),
         lambda: zinb.zinb_heads_plain(*ops, ZINB_EPS), lib3,
         "three products", 3 * prod, in_bytes + A * 4),
        ("zinb_fwdbwd", lambda: zinb.zinb_fwdbwd(*ops, ZINB_EPS),
         lambda: zinb.zinb_grads_plain(*ops, ZINB_EPS), lib9,
         "nine products", 9 * prod, in_bytes + A * 4 + grad_bytes),
        ("zinb_bwd", lambda: zinb.zinb_bwd(cot, h, heads, x, ZINB_EPS),
         lambda: zinb.zinb_bwd_plain(cot, h, heads, x, ZINB_EPS),
         lib9, "nine products", 9 * prod, in_bytes + A * 4 + grad_bytes))
    for name, kern, plain, lib, lib_what, flops, nbytes in timed:
        ms = cuda_ms(torch, kern, iters=10)
        pl = plain_ms(torch, plain)
        bound, by = flops_bound_ms(flops, nbytes, dname, tensor_cores=True)
        # the passes and the reductions on the device
        parts = kernel_device_ms(torch, kern)
        split = {k: v for k, v in parts.items() if "zinb" in k}
        print(f"  {tag}: {name} device ms by kernel: " + ", ".join(
            f"{re.search(r'zinb_[a-z_]+', k).group(0)} {v:.4f}"
            for k, v in sorted(split.items()))
            + f"; total {sum(split.values()):.4f}")
        print(f"  {tag}: {name} kernel_ms {ms:.4f} plain_ms {pl:.4f} "
              f"library_ms({lib_what}) {lib:.4f} bound_ms {bound:.4f} ({by}) "
              f"share_of_bound {bound / ms:.3f}")
        if item == 4:
            records[name] = {"max_abs_err": max_abs[name], "ms": ms,
                             "plain_ms": pl, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib}
    if item == 4:
        # what the element math costs: the same launch with every count
        # zero (no lgamma/digamma difference) and with every count positive
        # (all of them)
        for what, xv in (("all x = 0", torch.zeros_like(x)),
                         ("all x > 0", x + 1.0)):
            alt = ops[:7] + [xv]
            f_ms = cuda_ms(torch, lambda: zinb.fused_zinb(*alt, ZINB_EPS),
                           iters=10)
            t_ms = cuda_ms(torch, lambda: zinb.zinb_fwdbwd(*alt, ZINB_EPS),
                           iters=10)
            print(f"  {tag}: {what}: zinb_fwd {f_ms:.4f} ms, "
                  f"zinb_fwdbwd {t_ms:.4f} ms")
            del alt, xv


def categorical_posterior(torch, g, shape, pruned: int = 0):
    """Probabilities (…, C) like the model's tau-sharpened posterior is
    before it saturates; the last ``pruned`` categories exactly zero, as a
    pruning mask leaves them."""
    z = torch.randn(shape, generator=g, device=DEV) * 3.0
    if pruned:
        z[..., -pruned:] = -math.inf
    return torch.softmax(z, dim=-1).contiguous()


def phase_gumbel(torch, check) -> dict:
    """Kernels #9 and #10 and the sharpen variant vs their plain versions;
    returns the records of the main case (A=5, B=5000, C=92, the uniforms
    drawn in the kernel, soft sample: what a training step launches)."""
    import numpy as np
    from dvae_tpu_torch.ops import gumbel as gm
    print("phase 2: gumbel_fwd / gumbel_bwd kernels and the sharpen variant "
          "vs plain version")
    g = torch.Generator(device=DEV).manual_seed(SEED + 5)
    eps, temp = GUMBEL_EPS, 0.7
    records = {}
    # the production shape, ragged rows, C = 100, 120, 200, 300 and 30 (row
    # plans of 1 to 32 lanes), C not a multiple of 4 (scalar loads); 39,995
    # rows, more groups than 8 blocks an SM hold (#9's blocks stride over
    # two, the second loaded during the first's math); past the 512
    # columns #10 and, from 1025, #9 keep in registers (fault C7): 513,
    # 600, 1024, 2048 and 4099 (chunks of #9; scalar loads), ragged rows
    # throughout
    shapes = [((A, B, C), 0), ((A, B, C), 12), ((A, 4999, C), 0),
              ((A, 7999, C), 3),
              ((A, TAIL, 100), 0), ((3, TAIL, 120), 7), ((2, 333, 200), 0),
              ((2, 129, 300), 5), ((3, 257, 30), 0), ((2, 301, 93), 4),
              ((2, 333, 513), 0), ((3, 129, 600), 5), ((2, 257, 1024), 0),
              ((2, 77, 2048), 0), ((2, 97, 4099), 3)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = gm._lib()
    for n, c in [(int(np.prod(sh[:-1])), sh[-1]) for sh, _ in shapes] + [
            (7, 1), (33, 3), (1000, 12), (10 ** 6, 92)]:
        out = (ctypes.c_longlong * 6)()
        rcode = lib.gumbel_fwd_plan(n, c, sms, out)
        twin = gm.gumbel_plan(n, c, sms)
        check(rcode == 0 and tuple(out) == tuple(twin[k] for k in (
            "lanes", "quads", "chunks", "rows", "groups", "grid")),
            f"({n}, {c}): gumbel_fwd plan {tuple(out)} (lanes, quads, "
            f"chunks, rows a group, groups, blocks on {sms} SMs) equals the "
            "Python twin's")
    for shape, pruned in shapes:
        tag = f"{shape}" + (f" {pruned} pruned" if pruned else "")
        phi = categorical_posterior(torch, g, shape, pruned)
        u = torch.rand(shape, generator=g, device=DEV)
        dy = torch.randn(shape, generator=g, device=DEV)

        # forward, explicit uniforms: soft, and hard with its soft residual
        y, _ = gm.gumbel_fwd(3, phi, u, temp, eps)
        y0 = gm.gumbel_softmax_plain(phi, u, temp, eps)
        ys, yh = gm.gumbel_fwd(3, phi, u, temp, eps, hard=True)
        torch.cuda.synchronize()
        e_y = rel_err(torch, y, y0)
        check(e_y <= TOL_GUMBEL and bool(torch.isfinite(y).all()),
              f"{tag}: gumbel_fwd(u) rel err {e_y:.2e} (tol "
              f"{TOL_GUMBEL:.0e}), finite")
        one_hot = bool(((yh == 0) | (yh == 1)).all()
                       and (yh.sum(-1) == 1).all())
        same_arg = bool((yh.argmax(-1) == ys.argmax(-1)).all())
        agree = (yh.argmax(-1) == y0.argmax(-1)).float().mean().item()
        check(one_hot and same_arg and bool(torch.equal(ys, y))
              and agree >= 0.9999,
              f"{tag}: hard rows are one-hot at the argmax of the soft "
              f"sample of the same launch; argmax agrees with the plain "
              f"version on {agree:.6f} of the rows (min 0.9999)")
        if pruned:
            check(float(yh[..., -pruned:].max()) == 0.0,
                  f"{tag}: pruned categories (phi = 0) are never the argmax "
                  f"(soft mass at most {float(y[..., -pruned:].max()):.1e})")

        # forward, uniforms drawn in the kernel: the numpy twin's numbers
        ku = gm.kernel_uniform(9, shape, DEV)
        twin = torch.from_numpy(gm.philox_uniform(9, shape)).to(DEV)
        in_range = bool((ku >= 0).all() and (ku < 1).all())
        check(bool(torch.equal(ku, twin)) and in_range,
              f"{tag}: in-kernel uniforms equal their numpy version bit for "
              f"bit, all in [0, 1) (mean {ku.mean().item():.4f})")
        yp, _ = gm.gumbel_fwd(9, phi, None, temp, eps)
        e_p = rel_err(torch, yp, gm.gumbel_softmax_plain(phi, twin, temp,
                                                         eps))
        check(e_p <= TOL_GUMBEL,
              f"{tag}: gumbel_fwd(seed) vs plain on the twin's uniforms rel "
              f"err {e_p:.2e} (tol {TOL_GUMBEL:.0e})")
        # the forward's own draws: the same launch fed the twin's uniforms
        # gives the same bits, soft and hard
        ypu, _ = gm.gumbel_fwd(3, phi, twin, temp, eps)
        hp = gm.gumbel_fwd(9, phi, None, temp, eps, hard=True)
        hpu = gm.gumbel_fwd(3, phi, twin, temp, eps, hard=True)
        check(bool(torch.equal(yp, ypu) and torch.equal(hp[0], hpu[0])
                   and torch.equal(hp[1], hpu[1]) and torch.equal(hp[0], yp)),
              f"{tag}: gumbel_fwd(seed) equals gumbel_fwd(u = philox_uniform) "
              "bit for bit, soft and hard: the forward draws the numpy "
              "twin's uniforms")
        del ypu, hp, hpu

        # backward vs plain and vs autograd of the eager formula
        dphi, dtemp = gm.gumbel_bwd(y, phi, dy, temp, eps)
        dphi0, dtemp0 = gm.gumbel_softmax_bwd_plain(y, phi, dy, temp, eps)
        pa = phi.clone().requires_grad_()
        ta = torch.tensor(temp, device=DEV, requires_grad=True)
        ya = gm.gumbel_softmax_plain(pa, u, ta, eps)
        ga, gt = torch.autograd.grad(ya, (pa, ta), dy, retain_graph=True)
        torch.cuda.synchronize()
        e_d = rel_err(torch, dphi, dphi0)
        e_t = abs(dtemp.item() - dtemp0.item()) / abs(dtemp0.item())
        e_da = rel_err(torch, dphi, ga)
        e_ta = abs(dtemp.item() - gt.item()) / abs(gt.item())
        check(e_d <= TOL_GUMBEL and e_t <= TOL_GUMBEL
              and bool(torch.isfinite(dphi).all()) and dtemp0.item() != 0.0,
              f"{tag}: gumbel_bwd dphi rel err {e_d:.2e}, dtemp "
              f"{dtemp.item():.6g} rel err {e_t:.2e} vs plain (tol "
              f"{TOL_GUMBEL:.0e}), finite")
        check(e_da <= TOL_GUMBEL_AUTOGRAD and e_ta <= TOL_DTEMP_AUTOGRAD,
              f"{tag}: vs autograd of the eager formula dphi {e_da:.2e} "
              f"(tol {TOL_GUMBEL_AUTOGRAD:.0e}), dtemp {e_ta:.2e} (tol "
              f"{TOL_DTEMP_AUTOGRAD:.0e})")
        dphi_only, none = gm.gumbel_bwd(y, phi, dy, temp, eps,
                                        want_dtemp=False)
        t_dev = torch.tensor([temp], device=DEV)
        yt, _ = gm.gumbel_fwd(3, phi, u, t_dev, eps)
        dphi_t, dtemp_t = gm.gumbel_bwd(y, phi, dy, t_dev, eps)
        check(none is None and bool(torch.equal(dphi_only, dphi))
              and bool(torch.equal(yt, y) and torch.equal(dphi_t, dphi)
                       and torch.equal(dtemp_t, dtemp)),
              f"{tag}: the same bits without dtemp and with the temperature "
              "read from a device scalar")

        # the autograd function end to end, soft and straight-through
        grads = []
        for hard in (False, True):
            pf = phi.clone().requires_grad_()
            tf = torch.tensor(temp, device=DEV, requires_grad=True)
            out = gm.gumbel_softmax_fused(3, pf, u, tf, eps, hard)
            grads.append(torch.autograd.grad(out, (pf, tf), dy))
        check(bool(torch.equal(grads[0][0], dphi)
                   and torch.equal(grads[1][0], dphi)
                   and torch.equal(grads[0][1], dtemp)
                   and torch.equal(grads[1][1], dtemp)),
              f"{tag}: gumbel_softmax_fused hands autograd the kernel's "
              "dphi and dtemp, the same under hard (straight-through)")

        # the sharpen variant: logits as the model's c_prob, tau = 0.005
        logits = categorical_posterior(torch, g, shape)
        sh = gm.sharpen_gumbel_fused(3, logits, 0.005, temp, eps, u=u)
        sh0 = gm.gumbel_softmax_plain(logits, u, temp, eps, tau=0.005)
        shh = gm.sharpen_gumbel_fused(3, logits, 0.005, temp, eps,
                                      hard=True, u=u)
        shp = gm.sharpen_gumbel_fused(9, logits, 0.005, temp, eps)
        shp0 = gm.gumbel_softmax_plain(logits, twin, temp, eps, tau=0.005)
        e_s = max(rel_err(torch, sh, sh0), rel_err(torch, shp, shp0))
        check(e_s <= TOL_GUMBEL
              and bool((shh.argmax(-1) == sh.argmax(-1)).all()
                       and (shh.sum(-1) == 1).all()),
              f"{tag}: sharpen variant (tau 0.005) rel err {e_s:.2e} (tol "
              f"{TOL_GUMBEL:.0e}), its hard form one-hot at the argmax")

        again = (gm.gumbel_fwd(3, phi, u, temp, eps, hard=True),
                 gm.gumbel_fwd(9, phi, None, temp, eps),
                 gm.gumbel_bwd(y, phi, dy, temp, eps),
                 gm.sharpen_gumbel_fused(3, logits, 0.005, temp, eps, u=u))
        check(bool(torch.equal(again[0][0], ys) and torch.equal(again[0][1], yh)
                   and torch.equal(again[1][0], yp)
                   and torch.equal(again[2][0], dphi)
                   and torch.equal(again[2][1], dtemp)
                   and torch.equal(again[3], sh)),
              f"{tag}: repeated launches bit-identical")
        # one kernel a call, by the profiler's names (it may drop some or
        # all events of a session, never add any: up to three sessions)
        wide_f, wide_b = shape[-1] > 1024, shape[-1] > 512
        for what, fn, counter, want in (
                ("gumbel_fwd", lambda: gm.gumbel_fwd(9, phi, None, temp, eps),
                 gm.gumbel_fwd,
                 "gumbel_fwd_wide" if wide_f else "gumbel_fwd_rows"),
                ("gumbel_bwd", lambda: gm.gumbel_bwd(y, phi, dy, temp, eps,
                                                     want_dtemp=False),
                 gm.gumbel_bwd,
                 "gumbel_bwd_wide" if wide_b else "gumbel_bwd_rows")):
            before = counter.launches
            for _ in range(3):
                names = kernel_launches(torch, fn)
                if names:
                    break
            name = next(iter(names), "")
            check(len(names) == 1 and want in name
                  and 0.0 < names[name] <= 1.0
                  and (counter.launches - before) % 6 == 0,
                  f"{tag}: {what} one kernel a call by the profiler's names "
                  f"({name[:60]} {names.get(name)}) and by the counter")

        if shape == (A, B, C) and not pruned:
            n_el = A * B * C
            it = TIMING_ITERS
            logphi = torch.log(phi + eps)
            t_fwd = cuda_ms(torch, lambda: gm.gumbel_fwd(9, phi, None, temp,
                                                         eps), iters=it)
            t_fwd_u = cuda_ms(torch, lambda: gm.gumbel_fwd(3, phi, u, temp,
                                                           eps), iters=it)
            t_fwd_h = cuda_ms(torch, lambda: gm.gumbel_fwd(
                9, phi, None, temp, eps, hard=True), iters=it)
            t_plain = cuda_ms(torch, lambda: gm.gumbel_softmax_plain(
                phi, u, temp, eps), iters=it)
            t_lib = cuda_ms(torch, lambda: torch.nn.functional.gumbel_softmax(
                logphi, tau=temp), iters=it)
            t_bwd = cuda_ms(torch, lambda: gm.gumbel_bwd(
                y, phi, dy, temp, eps, want_dtemp=False), iters=it)
            t_bwd_t = cuda_ms(torch, lambda: gm.gumbel_bwd(
                y, phi, dy, temp, eps), iters=it)
            t_bplain = cuda_ms(torch, lambda: gm.gumbel_softmax_bwd_plain(
                y, phi, dy, temp, eps), iters=it)
            t_blib = cuda_ms(torch, lambda: torch.autograd.grad(
                ya, (pa, ta), dy, retain_graph=True), iters=it)
            t_sh = cuda_ms(torch, lambda: gm.sharpen_gumbel_fused(
                9, logits, 0.005, temp, eps), iters=it)
            t_shplain = cuda_ms(torch, lambda: gm.gumbel_softmax_plain(
                logits, u, temp, eps, tau=0.005), iters=it)
            # on the device alone (the event times above include the
            # host's enqueue where that is the slower of the two)
            d_fwd = device_ms(torch, lambda: gm.gumbel_fwd(9, phi, None, temp,
                                                           eps))
            d_bwd = device_ms(torch, lambda: gm.gumbel_bwd(
                y, phi, dy, temp, eps, want_dtemp=False))
            d_sh = device_ms(torch, lambda: gm.sharpen_gumbel_fused(
                9, logits, 0.005, temp, eps))
            d_plain = device_ms(torch, lambda: gm.gumbel_softmax_plain(
                phi, u, temp, eps))
            d_bplain = device_ms(torch, lambda: gm.gumbel_softmax_bwd_plain(
                y, phi, dy, temp, eps))
            # instructions: OPS_GUMBEL_FWD / _BWD an element at the FP32
            # issue rate, the forward's Philox multiplies at half of it
            timed = (
                ("gumbel_fwd", t_fwd, d_fwd, t_plain, d_plain, t_lib,
                 "F.gumbel_softmax on log phi", 2 * n_el * 4,
                 OPS_GUMBEL_FWD, PHILOX_MULS, (y - y0).abs().max().item()),
                ("gumbel_bwd", t_bwd, d_bwd, t_bplain, d_bplain, t_blib,
                 "autograd.grad of the eager chain", 4 * n_el * 4,
                 OPS_GUMBEL_BWD, 0, max((dphi - dphi0).abs().max().item(),
                                        abs(dtemp.item() - dtemp0.item()))),
                ("gumbel_sharpen", t_sh, d_sh, t_shplain, None, None, "",
                 2 * n_el * 4, OPS_GUMBEL_FWD + OPS_EXP + OPS_DIV,
                 PHILOX_MULS, (sh - sh0).abs().max().item()))
            for (name, ms, dev, pl, dpl, lib, lib_what, nbytes, ops, muls,
                 err) in timed:
                bound, by, b_ms, o_ms = simt_bound_ms(ops * n_el,
                                                      muls * n_el, nbytes)
                lib_s = "none" if lib is None else f"{lib:.4f} ({lib_what})"
                dpl_s = "" if dpl is None else f" (device {dpl:.4f})"
                print(f"  {tag}: {name} kernel_ms {ms:.4f} (device {dev:.4f}) "
                      f"plain_ms {pl:.4f}{dpl_s} library_ms {lib_s} bound_ms "
                      f"{bound:.4f} ({by}; bytes {b_ms:.4f}, operations "
                      f"{o_ms:.4f}) share_of_bound {bound / ms:.3f} (device "
                      f"{bound / dev:.3f})")
                records[name] = {"max_abs_err": err, "ms": ms,
                                 "device_ms": dev, "plain_ms": pl,
                                 "bound_ms": bound, "bound_by": by,
                                 "bytes_bound_ms": b_ms, "ops_bound_ms": o_ms,
                                 "share_of_bound": bound / dev if dev else
                                 None, "library_ms": lib}
            print(f"  {tag}: gumbel_fwd with given u {t_fwd_u:.4f} ms, hard "
                  f"with its soft residual {t_fwd_h:.4f} ms; gumbel_bwd with "
                  f"dtemp (a second launch) {t_bwd_t:.4f} ms")
            # what a training step pays: sample and gradient through
            # autograd, as the model calls them, host clock
            from dvae_tpu_torch.models.sampling import gumbel_softmax
            gen = torch.Generator(device=DEV).manual_seed(SEED)
            pg = phi.clone().requires_grad_()

            def eager_trip():
                out = gumbel_softmax(pg, temp, eps, generator=gen)
                return torch.autograd.grad(out, pg, dy)

            def fused_trip():
                out = gm.gumbel_softmax_fused(9, pg, None, temp, eps)
                return torch.autograd.grad(out, pg, dy)

            h_eager, h_fused = (host_ms(torch, f) for f in (eager_trip,
                                                            fused_trip))
            d_eager, d_fused = (device_ms(torch, f) for f in (eager_trip,
                                                              fused_trip))
            print(f"  {tag}: sample + gradient through autograd, host clock "
                  f"(device): eager sampler {h_eager:.4f} ({d_eager:.4f}) "
                  f"ms, fused {h_fused:.4f} ({d_fused:.4f}) ms")
            del pg, logphi
        del phi, u, dy, y, y0, ys, yh, yp, dphi, dphi0, ya, pa, ga, logits
    torch.cuda.empty_cache()
    return records


def degenerate_posteriors(torch, kind: str):
    """The two hard inputs of the coupling distance at production shape:
    one-hot posteriors with categories dead in every arm
    (tests/test_ops.py:55), and an arm collapsed onto one category
    (tests/test_ops.py:73)."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 7)
    if kind == "dead":
        live = C - 24
        lab = torch.randint(0, live, (A, B), generator=g, device=DEV)
        return torch.nn.functional.one_hot(lab, C).float().contiguous()
    c = torch.softmax(torch.randn((A, B, C), generator=g, device=DEV) / 0.05,
                      dim=-1)
    col = torch.full((B, C), 1e-8, device=DEV)
    col[:, 3] = 1.0
    c[0] = col / col.sum(-1, keepdim=True)
    return c.contiguous()


def phase_coupling(torch, check) -> dict:
    """Kernel #11 (one cooperative launch) vs its plain version and the
    eager distance; returns the record of the main case (A=5, B=5000,
    C=92)."""
    from dvae_tpu_torch.models.losses import coupling_distance
    from dvae_tpu_torch.ops import coupling as cp
    print("phase 2: coupling kernel vs plain version")
    lib = cp._lib()
    g = torch.Generator(device=DEV).manual_seed(SEED + 6)
    eps = GUMBEL_EPS
    record = {}
    # (5, 50000, 92): a slab of 379 rows, whose logs do not fit its shared
    # memory; (10, 5000, 1024): the most arms and categories the templated
    # kernel takes, the same; fault C8: past 10 arms or 1024 categories the
    # general kernel, (12, 5000, 92) to (16, 2000, 1100)
    shapes = [(A, B, C), (A, 4999, C), (A, TAIL, 100), (3, TAIL, 120),
              (2, 777, 300), (10, 130, 17), (2, 64, 10), (A, 50000, C),
              (10, B, 1024)] + C8_SHAPES
    for shape in shapes:
        tag = f"{shape}"
        out = (ctypes.c_longlong * 6)()
        rcode = lib.coupling_plan(*shape, out)
        twin = cp.coupling_plan(*shape)
        general = shape[0] > 10 or shape[2] > 1024
        check(rcode == 0 and tuple(out) == (
            twin["nb"], twin["rows"], twin["piece"], int(twin["keep"]),
            twin["smem"], int(twin["general"]))
            and twin["general"] == general
            and twin["rows"] == -(-shape[1] // twin["nb"])
            and twin["nb"] * twin["rows"] >= shape[1],
            f"{tag}: coupling plan {tuple(out)} (blocks, rows a slab, rows "
            "a piece, logs kept, shared bytes, general kernel) equals the "
            "Python twin's; the slabs cover B once")
        c = categorical_posterior(torch, g, shape)
        gram = cp.coupling_gram_fused(c, eps)
        gram0 = cp.coupling_gram_plain(c, eps)
        dist = cp.coupling_distance_fused(c, eps)
        eager = coupling_distance(c, eps)
        torch.cuda.synchronize()
        e_g = rel_err(torch, gram, gram0)
        e_d = abs(dist.item() - eager.item()) / abs(eager.item())
        n_arm = shape[0]
        from_gram = (n_arm * gram.diagonal().sum() - gram.sum()) / shape[1]
        e_f = abs(dist.item() - from_gram.item()) / abs(eager.item())
        check(e_g <= TOL_GRAM and bool(torch.equal(gram, gram.t())),
              f"{tag}: Gram rel err {e_g:.2e} (tol {TOL_GRAM:.0e}), "
              "symmetric")
        check(e_d <= TOL_DIST and e_f <= TOL_DIST,
              f"{tag}: distance {dist.item():.6g} vs eager "
              f"{eager.item():.6g} rel err {e_d:.2e}, vs its own Gram "
              f"{e_f:.2e} (tol {TOL_DIST:.0e})")
        x = c.clone().requires_grad_()
        x0 = c.clone().requires_grad_()
        (gx,) = torch.autograd.grad(2.0 * cp.coupling_distance_fused(x, eps),
                                    x)
        (gx0,) = torch.autograd.grad(2.0 * coupling_distance(x0, eps), x0)
        check(bool(torch.equal(gx, gx0)),
              f"{tag}: the gradient is the eager form's, bit for bit")
        again = [cp.coupling_gram_fused(c, eps) for _ in range(3)]
        check(bool(all(torch.equal(u, gram) for u in again)
                   and torch.equal(cp.coupling_distance_fused(c, eps), dist)),
              f"{tag}: repeated launches bit-identical")
        # the profiler may drop some or all events of a session, never add
        # any: up to three sessions until one records the call's kernels
        before = cp.coupling_gram_fused.launches
        for _ in range(3):
            names = kernel_launches(torch,
                                    lambda: cp.coupling_gram_fused(c, eps))
            if names:
                break
        kname = "coupling_general" if general else "coupling_fused"
        check(len(names) == 1 and kname in next(iter(names))
              and 0.0 < next(iter(names.values())) <= 1.0
              and (cp.coupling_gram_fused.launches - before) % 6 == 0,
              f"{tag}: one kernel a call by the profiler's names {names} and "
              "by the counter")
        if shape in [(A, B, C), (A, 50000, C), (10, B, 1024)] + C8_SHAPES:
            it = TIMING_ITERS
            ms = cuda_ms(torch, lambda: cp.coupling_distance_fused(c, eps),
                         iters=it)
            dev = device_ms(torch,
                            lambda: cp.coupling_distance_fused(c, eps))
            n_el = shape[0] * shape[1] * shape[2]
            pairs = shape[0] * (shape[0] + 1) // 2
            # instructions at the FP32 issue rate: one log, the three sums
            # and prec an element, and the A(A+1)/2 multiply-adds of each
            # of the B*C positions
            ops = (OPS_LOG + 5.0) * n_el + pairs * n_el / n_arm
            bound, by, bytes_ms, ops_ms = simt_bound_ms(
                ops, 0, n_el * 4 + (n_arm * n_arm + 1) * 4)
            line = (f"  {tag}: coupling kernel_ms {ms:.4f} (device "
                    f"{dev:.4f}) bound_ms {bound:.4f} ({by}; bytes "
                    f"{bytes_ms:.4f}, operations {ops_ms:.4f}) "
                    f"share_of_bound {bound / ms:.3f}")
            if shape == (A, B, C):
                pl = cuda_ms(torch, lambda: cp.coupling_gram_plain(c, eps),
                             iters=it)
                lib_ms = cuda_ms(torch, lambda: coupling_distance(c, eps),
                                 iters=it)
                dlib = device_ms(torch, lambda: coupling_distance(c, eps))
                line += (f" plain_ms {pl:.4f} library_ms {lib_ms:.4f} "
                         f"(device {dlib:.4f}; the eager coupling_distance: "
                         "log, var, multiply, einsum)")
            print(line)
            if shape == (A, B, C):
                xg = c.clone().requires_grad_()
                trips = [lambda f=f: torch.autograd.grad(f(xg, eps), xg)
                         for f in (coupling_distance,
                                   cp.coupling_distance_fused)]
                h_eager, h_fused = (host_ms(torch, f) for f in trips)
                d_eager, d_fused = (device_ms(torch, f) for f in trips)
                print(f"  {tag}: distance + gradient through autograd, host "
                      f"clock (device): eager {h_eager:.4f} ({d_eager:.4f}) "
                      f"ms, fused forward with the eager form recomputed in "
                      f"its backward {h_fused:.4f} ({d_fused:.4f}) ms")
                del xg
                record = {"max_abs_err": max(
                    (gram / shape[1] - gram0 / shape[1]).abs().max().item(),
                    abs(dist.item() - eager.item())),
                    "ms": ms, "device_ms": dev, "plain_ms": pl,
                    "bound_ms": bound, "bound_by": by,
                    "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
                    "library_ms": lib_ms}
        del c, gram, gram0, x, x0, gx, gx0, again
    for kind in ("dead", "collapsed"):
        c = degenerate_posteriors(torch, kind)
        dist = cp.coupling_distance_fused(c, eps)
        eager = coupling_distance(c, eps)
        plain = cp.coupling_distance_plain(c, eps)
        e_d = abs(dist.item() - eager.item()) / abs(eager.item())
        e_p = abs(dist.item() - plain.item()) / abs(plain.item())
        check(math.isfinite(dist.item()) and eager.item() > 1.0
              and e_d <= TOL_DIST_DEGENERATE and e_p <= TOL_DIST_DEGENERATE
              and torch.equal(cp.coupling_distance_fused(c, eps), dist),
              f"{kind} posteriors {(A, B, C)}: distance {dist.item():.6g} "
              f"finite, vs eager {eager.item():.6g} rel err {e_d:.2e}, vs "
              f"plain {e_p:.2e} (tol {TOL_DIST_DEGENERATE:.0e}), repeats "
              "bit-identical")
        del c
    torch.cuda.empty_cache()
    return record


def decoder_inputs(torch, g, dtype, rows, per_arm, on_grid=False, f=None):
    """Operands of the whole-decoder kernels at the production widths
    (Z = C + 2 = 94 -> L = 10 -> F = 100 x 4 -> D): z as the model makes it
    (a soft categorical sample beside two state values), weights scaled so
    that about half of every layer's units are active.

    ``on_grid``: z on multiples of 1/4, trunk weights on 1/8 and each bias
    on its layer's grid, W_11 on 1/64 and b_11 on 1/4096, small enough
    that every activation and y of the output layer is exact in f32 in any
    order of its sums (h_5 on 2^-17, y on 2^-23, both under 24 bits; bf16
    activations are the same exact values rounded once).  ``f``: another
    width of fc7..fc10's outputs than F."""
    f = f or F
    if on_grid:
        def ints(lo, hi, shape):
            return torch.randint(lo, hi + 1, shape, generator=g,
                                 device=DEV).float()
        args = [ints(0, 4, (A, rows, C + 2)) / 4]
        res = 2
        for k, n in ((C + 2, 10), (10, f), (f, f), (f, f), (f, f)):
            res += 3
            m = 2 if k == 10 else 1
            args += [ints(-m, m, (A, k, n)) / 8, ints(-4, 4, (A, n)) / 2**res]
        args += [ints(-4, 4, (A, f, D)) / 64, ints(-400, 400, (A, D)) / 4096]
        shape = (A, rows, D) if per_arm else (rows, D)
        args.append(torch.relu(torch.randn(shape, generator=g, device=DEV)))
        return [t.to(dtype).contiguous() for t in args]
    c = torch.softmax(torch.randn((A, rows, C), generator=g, device=DEV) * 3,
                      dim=-1)
    st = torch.randn((A, rows, 2), generator=g, device=DEV)
    args = [torch.cat([c, st], dim=-1)]
    for k, n in ((C + 2, 10), (10, f), (f, f), (f, f), (f, f), (f, D)):
        args.append(torch.randn((A, k, n), generator=g, device=DEV)
                    * (1.4 / math.sqrt(k)))
        args.append(torch.randn((A, n), generator=g, device=DEV) * 0.1)
    shape = (A, rows, D) if per_arm else (rows, D)
    args.append(torch.relu(torch.randn(shape, generator=g, device=DEV)))
    return [t.to(dtype).contiguous() for t in args]


def decoder_clear_rows(torch, z, trunk, w11, b11):
    """Rows (A, B) of the whole decoder on which every |y| of the plain
    version (f32 baddbmm on activations rounded to z's dtype, as
    ``decoder_fwdbwd_reference`` takes them) exceeds KINK_Y, in each of the
    five trunk layers and in the output layer: the rows of dz that no flip
    of a gate or of gm at a ReLU kink can reach."""
    rows = torch.ones(z.shape[:2], dtype=torch.bool, device=z.device)
    h = z
    for w, b in trunk:
        y = torch.baddbmm(b.float()[:, None, :], h.float(), w.float())
        rows &= (y.abs() > KINK_Y).all(dim=2)
        h = torch.relu(y).to(z.dtype)
    for i in range(z.shape[0]):
        y = torch.addmm(b11[i].float()[None, :], h[i].float(), w11[i].float())
        rows[i] &= (y.abs() > KINK_Y).all(dim=1)
        del y
    return rows


def phase_decoder(torch, check) -> dict:
    """Kernels #12 and #13 vs their plain versions; returns the records of
    the main case (f32, shared x, B=5000; bf16 under ``*_bf16``)."""
    from dvae_tpu_torch.ops import decoder as dec
    from dvae_tpu_torch.ops.recon import recon_fwdbwd
    print("phase 2: decoder_fwd / decoder_fwdbwd kernels vs plain version")
    g = torch.Generator(device=DEV).manual_seed(SEED + 8)
    g_grid = torch.Generator(device=DEV).manual_seed(SEED + 22)
    records = {}
    dims = [C + 2, 10, F, F, F, F, D]
    macs = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    n_trunk = sum((k + 1) * n for k, n in zip(dims[:-2], dims[1:-1]))

    def flat(out):
        return [out[2], *(t for pair in out[3] for t in pair), out[4], out[5]]

    names = ["dz"] + [f"d{p}{6 + i}" for i in range(5) for p in "Wb"] \
        + ["dW11", "db11"]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        item = 4 if dtype == torch.float32 else 2
        tol_g = TOL_DEC_GRAD[dname]
        for rows, per_arm, on_grid in itertools.product(
                (B, TAIL), (False, True), (False, True)):
            tag = (f"{dname} B={rows} x="
                   f"{'per-arm' if per_arm else 'shared'}"
                   + (", on the grid" if on_grid else ""))
            ops = decoder_inputs(torch, g_grid if on_grid else g, dtype,
                                 rows, per_arm, on_grid)
            z, w11, b11, x = ops[0], ops[11], ops[12], ops[13]
            trunk = [(ops[1 + 2 * i], ops[2 + 2 * i]) for i in range(5)]
            sk, mk = dec.fused_decoder_mse(*ops)
            sp, mp = dec.decoder_mse_reference(*ops)
            got = dec.decoder_fwdbwd(z, trunk, w11, b11, x)
            want = dec.decoder_fwdbwd_reference(z, trunk, w11, b11, x)
            torch.cuda.synchronize()
            rel = ((sk - sp).abs() / sp.abs()).max().item()
            dm = (mk - mp).abs().max().item()
            check(rel <= TOL_SUMSQ[dname],
                  f"{tag}: decoder_fwd sumsq max rel err {rel:.3e} "
                  f"(tol {TOL_SUMSQ[dname]:.0e})")
            check(dm <= TOL_DEC_MISM[dname] * rows * D,
                  f"{tag}: decoder_fwd mism max abs diff {dm:.0f} (tol "
                  f"{TOL_DEC_MISM[dname] * rows * D:.0f} of {rows * D})")
            check(bool(torch.equal(got[0], sk) and torch.equal(got[1], mk)),
                  f"{tag}: decoder_fwdbwd's sums equal decoder_fwd's bit "
                  "for bit")
            errs = [rel_err(torch, a, e)
                    for a, e in zip(flat(got), flat(want))]
            listed = " ".join(f"{n}={e:.1e}" for n, e in zip(names, errs))
            finite = got[2].dtype == dtype and all(
                bool(torch.isfinite(t).all()) for t in flat(got))
            # in bf16 every gated cotangent is rounded to bf16 for its
            # products, so where one lies within rounding of a bf16
            # midpoint, sums of its f32 value in another order flip it by
            # a bf16 step (2^-8 of it), and the steps compound down to dz,
            # an output in bf16: dz is held at one bf16 step, as h1..h5
            tol_dz = tol_g if item == 4 else TOL_Y_BF16
            # the kernel pass by pass, on its own workspaces: the trunk's
            # activations against the plain forward (a ReLU is
            # continuous, so no flip); kernel #2 on its own h5, bit for
            # bit; the trunk backward against the plain one on its own
            # activations and dh5 (the same gates, so no flip)
            kern = dec._fwdbwd_launch(z, trunk, w11, b11, x, 0.1, True)
            khs, kdh5 = kern[6], kern[7]
            phs = dec._trunk_forward(z, trunk)
            e_h = [rel_err(torch, a, e) for a, e in zip(khs, phs[1:])]
            tol_h = tol_g if item == 4 else TOL_Y_BF16
            check(max(e_h) <= tol_h,
                  f"{tag}: decoder_fwdbwd's h1..h5 vs the plain trunk "
                  "forward: rel err " + "/".join(f"{e:.1e}" for e in e_h)
                  + f" (tol {tol_h:.0e}"
                  + ("" if item == 4 else ": one bf16 rounding step") + ")")
            r2 = recon_fwdbwd(khs[-1], w11, b11, x)
            check(all(bool(torch.equal(u, v)) for u, v in zip(
                [kern[0], kern[1], kdh5, kern[4], kern[5]], r2)),
                  f"{tag}: decoder_fwdbwd's sums, dh5, dW11, db11 equal "
                  "recon_fwdbwd's on its own h5 bit for bit")
            pdz, pdt = dec._trunk_backward([z] + khs, trunk, kdh5)
            e_b = [rel_err(torch, a, e) for a, e in zip(
                [kern[2], *(t for pair in kern[3] for t in pair)],
                [pdz, *(t for pair in pdt for t in pair)])]
            check(e_b[0] <= tol_dz and max(e_b[1:]) <= tol_g and finite,
                  f"{tag}: decoder_fwdbwd's dz, dW6..db10 vs the plain "
                  "trunk backward on its own h1..h5 and dh5: rel err "
                  + " ".join(f"{n}={e:.1e}" for n, e in zip(names, e_b))
                  + f" (tol dz {tol_dz:.0e}, the others {tol_g:.0e}), "
                  "finite")
            del kern, khs, kdh5, phs, r2, pdz, pdt
            h5 = dec._trunk_forward(z, trunk)[-1].contiguous()
            if on_grid:
                check(errs[0] <= tol_dz and max(errs[1:]) <= tol_g
                      and finite,
                      f"{tag}: decoder_fwdbwd gradients rel err {listed} "
                      f"(tol dz {tol_dz:.0e}, the others {tol_g:.0e}), "
                      f"finite, dz in {dname}")
            else:
                # end to end, a gm or a gate that flips at a ReLU kink
                # moves the gradients of its row: dz on that row and every
                # trunk dW and db; so in f32 dz is held on the rows, dW11
                # and db11 on the columns, whose plain |y| all exceed
                # KINK_Y in every layer, at TOL_DEC_GRAD, and the trunk's
                # dW, db over all at TOL_DEC_KINK; in bf16 the trunk's
                # roundings flip with the order of its f32 sums as well,
                # so dz and dW11/db11 (on h5 one bf16 step apart) are held
                # over all at one bf16 step and the trunk's dW, db at
                # TOL_DEC_GRAD; the whole error printed
                rk = decoder_clear_rows(torch, z, trunk, w11, b11)
                _, ck = recon_clear_of_kink(torch, h5, w11, b11)
                e_clear = recon_held_errs(torch, [got[2], got[4], got[5]],
                                          [want[2], want[4], want[5]],
                                          rk, ck)
                what = (f"{tag}: decoder_fwdbwd dz on the "
                        f"{rk.float().mean():.4f} of rows, dW11/db11 on the "
                        f"{ck.float().mean():.4f} of columns with every "
                        f"plain |y| > {KINK_Y:.0e}: rel err "
                        + "/".join(f"{e:.1e}" for e in e_clear)
                        + f"; {int((~rk).sum())} rows at the kink reach "
                        f"every trunk dW, db; over all {listed}")
                if item == 4:
                    check(max(e_clear) <= tol_g
                          and max(errs[1:11]) <= TOL_DEC_KINK and finite,
                          what + f" (tol {tol_g:.0e} on the clear rows and "
                          f"columns, {TOL_DEC_KINK:.0e} for dW6..db10), "
                          "finite")
                else:
                    check(max(errs[0], *errs[11:]) <= TOL_Y_BF16
                          and max(errs[1:11]) <= tol_g and finite,
                          what + f" (tol {TOL_Y_BF16:.0e} for dz, dW11, "
                          f"db11 over all, {tol_g:.0e} for dW6..db10), "
                          "finite")
            again = dec.decoder_fwdbwd(z, trunk, w11, b11, x)
            sk2, mk2 = dec.fused_decoder_mse(*ops)
            check(bool(torch.equal(sk, sk2) and torch.equal(mk, mk2)
                       and torch.equal(again[0], got[0])
                       and all(torch.equal(u, v) for u, v in
                               zip(flat(again), flat(got)))),
                  f"{tag}: repeated launches of both kernels "
                  "bit-identical")
            # without the mismatch count: the same sumsq, mism 0
            s0, m0 = dec.fused_decoder_mse(*ops, 0.1, False)
            t0 = dec.decoder_fwdbwd(z, trunk, w11, b11, x, 0.1, False)
            check(bool(torch.equal(s0, sk) and torch.equal(t0[0], sk)
                       and float(m0.abs().max()) == 0.0
                       and float(t0[1].abs().max()) == 0.0
                       and torch.equal(t0[4], got[4])),
                  f"{tag}: with_mism off gives the same sumsq and "
                  "gradients, mism 0")
            # the output layer's gradients against kernel #2 on the plain
            # version's h5: bit for bit on the grid draw, on which every
            # activation and y is exact in any order, and off it (f32) on
            # the columns every y of which stays clear of the kink (#13's
            # h5 and the plain version's are summed in other orders, so y
            # parts where it lies within rounding of 0)
            r2 = recon_fwdbwd(h5, w11, b11, x)
            e2 = max(rel_err(torch, got[4], r2[3]),
                     rel_err(torch, got[5], r2[4]))
            if on_grid:
                check(bool(torch.equal(got[4], r2[3])
                           and torch.equal(got[5], r2[4])),
                      f"{tag}: dW11/db11 equal recon_fwdbwd's on the "
                      f"plain version's h5 bit for bit (rel err "
                      f"{e2:.1e})")
            else:
                held = recon_held_errs(torch, got[4:6], r2[3:5], cols=ck)
                what = (f"{tag}: dW11/db11 vs recon_fwdbwd on the plain "
                        f"version's h5, on the {ck.float().mean():.4f} of "
                        f"columns with every plain |y| > {KINK_Y:.0e}: rel "
                        "err " + "/".join(f"{e:.1e}" for e in held)
                        + f"; over all {e2:.1e} (a reading: "
                        + recon_nearest_kink(torch, h5, w11, b11, x,
                                             [r2[2], got[4], got[5]],
                                             [r2[2], r2[3], r2[4]]) + ")")
                if item == 4:
                    check(max(held) <= tol_g, what + f" (tol {tol_g:.0e})")
                else:
                    print(f"  {what}; in bf16 held on #13's own h5 above")
                del rk, ck
            del h5, r2
            if on_grid and rows == TAIL:
                # fault C5 end to end: a NaN of x where arm 1's r > 0
                # reaches that row's dz and the trunk gradients of every
                # unit active on it; the plain version's NaN pattern (the
                # JAX kernel's, by the CPU tests), on the grid draw where
                # every activation is exact; every other element, and
                # #12's sums of the arms that do not read it, bit for bit
                view = torch.int32 if item == 4 else torch.int16
                h5 = dec._trunk_forward(z, trunk)[-1]
                y = torch.baddbmm(b11.float()[:, None, :], h5.float(),
                                  w11.float())
                del h5
                for what, at, bits in nan_of_x_cases(torch, y, per_arm,
                                                      dtype):
                    bx = x.clone()
                    bx.view(view)[at] = bits
                    tn = dec.decoder_fwdbwd(z, trunk, w11, b11, bx)
                    pn = dec.decoder_fwdbwd_reference(z, trunk, w11, b11, bx)
                    sn, _ = dec.fused_decoder_mse(*ops[:13], bx)
                    reads = torch.isnan(pn[0])
                    n_dz = int(torch.isnan(tn[2]).any(dim=2).sum())
                    check(hold_nan_pattern(torch, [tn[0]] + flat(tn),
                                           [pn[0]] + flat(pn),
                                           [got[0]] + flat(got))
                          and hold_nan_pattern(torch, [sn], [tn[0]],
                                               [tn[0]])
                          and torch.equal(tn[1][~reads], got[1][~reads])
                          and (n_dz > 0) == ("r > 0" in what),
                          f"{tag}: a NaN of x where {what}: decoder_fwdbwd "
                          "NaN where the plain version is (sums of "
                          f"{int(reads.sum())} arms, {n_dz} dz rows, "
                          f"{int(torch.isnan(tn[3][0][0]).sum())} entries "
                          "of dW6), decoder_fwd's sums equal its own, "
                          "every other element bit for bit the clean "
                          "input's")
                    del bx, tn, pn, sn
                del y
            if on_grid:
                del ops, z, trunk, w11, b11, x, got, want, again, t0
                continue
            # a cotangent that differs per arm, through autograd
            cot = torch.linspace(-1.5, 2.5, A, device=DEV)
            live = [t.clone().requires_grad_() for t in ops[:13]]
            sa, ma = dec.fused_decoder_mse(*live, x)
            grads = torch.autograd.grad((cot * sa).sum(), live)
            # the kernel's unscaled gradients (held against the plain
            # version above) times the cotangent, in the operand type
            scaled = [(w_.float() * (cot[:, None, None] if w_.dim() == 3
                                     else cot[:, None])).to(dtype)
                      for w_ in flat(got)]
            check(all(bool(torch.equal(a, e))
                      for a, e in zip(grads, scaled))
                  and not ma.requires_grad
                  and all(gr.dtype == dtype for gr in grads),
                  f"{tag}: autograd with a per-arm cotangent equals the "
                  "kernel's unscaled gradients times the cotangent bit "
                  f"for bit, in {dname}, mism without gradient")
            del live, grads, scaled, sa
            # a NaN in one arm's operand reaches that arm only, whatever
            # its bits: the quiet NaN (0x7FC00000; bf16 0x7FC0) and the
            # card's own (0x7FFFFFFF; bf16 0x7FFF), which the f32 split
            # would turn into -0 (csrc/recon_passes.cuh quiet_copy); W11's
            # NaN in the row of arm 1's most active unit of h5, so that its
            # dh5 passes the gate
            others = [0, 2, 3, 4]
            f_live = int((dec._trunk_forward(z, trunk)[-1][1] > 0)
                         .sum(dim=0).argmax())
            nan_cases = (("z", 0, (1, 7, 3), False),
                         ("z", 0, (1, 7, 3), True),
                         ("W8", 5, (1, 4, 9), True),
                         ("W11", 11, (1, f_live, 42), True))
            for where, i, at, card_nan in nan_cases:
                bad = [t.clone() for t in ops[:13]]
                if item == 4:
                    bad[i].view(torch.int32)[at] = (
                        0x7FFFFFFF if card_nan else 0x7FC00000)
                else:
                    bad[i].view(torch.int16)[at] = (
                        0x7FFF if card_nan else 0x7FC0)
                sn, _ = dec.fused_decoder_mse(*bad, x)
                tn = dec.decoder_fwdbwd(
                    bad[0], [(bad[1 + 2 * k], bad[2 + 2 * k])
                             for k in range(5)], bad[11], bad[12], x)
                arm1 = [t[1] for t in flat(tn)]
                check(bool(torch.isnan(sn[1]) and torch.isnan(tn[0][1])
                           and any(torch.isnan(t).any() for t in arm1)
                           and torch.equal(sn[others], sk[others])
                           and torch.equal(tn[0][others], got[0][others])
                           and all(torch.equal(u[others], v[others])
                                   for u, v in zip(flat(tn), flat(got)))),
                      f"{tag}: a NaN ("
                      + ("the card's own" if card_nan else "quiet")
                      + f") in {where} of arm 1 makes that arm's sums and "
                      "some of its gradients NaN and leaves the other "
                      "arms' sums and gradients bit for bit")
                del bad, sn, tn, arm1
            if rows == B and not per_arm:
                f_ms = cuda_ms(torch, lambda: dec.fused_decoder_mse(*ops))
                t_ms = cuda_ms(torch, lambda: dec.decoder_fwdbwd(
                    z, trunk, w11, b11, x))
                f_dev = device_ms(torch,
                                  lambda: dec.fused_decoder_mse(*ops),
                                  iters=5)
                t_dev = device_ms(torch, lambda: dec.decoder_fwdbwd(
                    z, trunk, w11, b11, x), iters=5)
                f_pl = plain_ms(torch,
                                lambda: dec.decoder_mse_reference(*ops))
                t_pl = plain_ms(torch, lambda: dec.decoder_fwdbwd_reference(
                    z, trunk, w11, b11, x))

                def chain(args):
                    h = args[0]
                    for i in range(5):
                        h = torch.relu(torch.baddbmm(
                            args[2 + 2 * i][:, None, :], h,
                            args[1 + 2 * i]))
                    r = torch.relu(torch.baddbmm(args[12][:, None, :], h,
                                                 args[11]))
                    return ((r - x) ** 2).sum(dim=(1, 2))

                f_lib = cuda_ms(torch, lambda: chain(ops), iters=10)
                live = [t.clone().requires_grad_() for t in ops[:13]]
                t_lib = cuda_ms(torch, lambda: torch.autograd.grad(
                    chain(live).sum(), live), iters=10)
                del live
                in_bytes = (A * rows * dims[0] + A * n_trunk
                            + A * (F + 1) * D + rows * D) * item
                out_bytes = (A * rows * dims[0] * item
                             + (A * n_trunk + A * (F + 1) * D) * 4)
                timed = (
                    ("decoder_fwd", f_ms, f_dev, f_pl, f_lib,
                     "six baddbmm + loss, eager", 2.0 * A * rows * macs,
                     in_bytes + A * 8,
                     max((sk - sp).abs().max().item(), dm)),
                    ("decoder_fwdbwd", t_ms, t_dev, t_pl, t_lib,
                     "autograd of that chain", 6.0 * A * rows * macs,
                     in_bytes + A * 8 + out_bytes,
                     max((a - e).abs().max().item()
                         for a, e in zip([got[0]] + flat(got),
                                         [want[0]] + flat(want)))))
                calls = {"decoder_fwd":
                         lambda: dec.fused_decoder_mse(*ops),
                         "decoder_fwdbwd": lambda: dec.decoder_fwdbwd(
                             z, trunk, w11, b11, x)}
                for (name, ms, dev, pl, lib, what, flops, nbytes,
                     err) in timed:
                    bound, by = flops_bound_ms(flops, nbytes, dname,
                                               tensor_cores=True)
                    simt, _ = flops_bound_ms(flops, nbytes, "float32")
                    split = {}
                    for _ in range(2):  # once more if events were lost
                        parts = kernel_device_ms(torch, calls[name])
                        if sum(parts.values()) >= 0.5 * dev:
                            break
                    for k, v in parts.items():
                        m = re.search(r"(decoder|recon|quiet)_[a-z_]+", k)
                        key = m.group(0) if m else k[:40]
                        split[key] = split.get(key, 0.0) + v
                    print(f"  {tag}: {name} device ms by pass: "
                          + ", ".join(f"{k} {v:.4f}"
                                      for k, v in split.items())
                          + f"; total {sum(split.values()):.4f}")
                    print(f"  {tag}: {name} kernel_ms {ms:.4f} (device "
                          f"{dev:.4f}) plain_ms {pl:.4f} library_ms "
                          f"{lib:.4f} ({what}) bound_ms {bound:.4f} "
                          f"({by}) share_of_bound {bound / ms:.3f}; "
                          f"FP32-core bound {simt:.4f}")
                    suffix = "" if item == 4 else "_bf16"
                    rec = records.setdefault(name, {})
                    if item == 4:
                        rec["max_abs_err"] = err
                    rec.update({
                        f"ms{suffix}": ms, f"device_ms{suffix}": dev,
                        f"plain_ms{suffix}": pl,
                        f"bound_ms{suffix}": bound,
                        f"bound_by{suffix}": by,
                        f"library_ms{suffix}": lib,
                        f"device_ms_by_pass{suffix}": {
                            k: round(v, 4) for k, v in split.items()}})
            del ops, z, trunk, w11, b11, x, got, want, again, t0
            torch.cuda.empty_cache()
    return records


C6_WIDTHS = (160, 448)  # F of #2, #3, #6, #7, #8 past one chunk of 128
C6_TRUNK = 160          # trunk widths (out_7..out_10) of #12 and #13
C6_FC_DIM = 160         # fc_dim of the end-to-end runs
# the widest F each kernel takes in (f32, bf16), which its shared memory
# sets: the numbers of the kernels' sources and of the Python twins of
# their plans in tests/test_torch_wide.py
C6_LIMITS = {"recon_fwdbwd": (512, 1296), "zinb_fwdbwd": (616, 1440),
             "zinb_fwd": (784, 1456), "decoder_fwdbwd": (512, 1296),
             "decoder_fwd": (656, 1552)}


def call_rise(torch, fn) -> float:
    """Bytes by which one call of ``fn`` raises the allocator's peak over
    what was allocated before it: its outputs and its workspaces."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    del out
    return rise


def c6_time(torch, name, kern, plain, flops, nbytes, dname, tag) -> float:
    """Prints and returns the kernel's time at a C6 width beside its plain
    version's and the tensor-core bound."""
    ms = cuda_ms(torch, kern, iters=5, warmup=1)
    pl = plain_ms(torch, plain)
    bound, by = flops_bound_ms(flops, nbytes, dname, tensor_cores=True)
    print(f"  {tag}: {name} kernel_ms {ms:.4f} plain_ms {pl:.4f} bound_ms "
          f"{bound:.4f} ({by}) share_of_bound {bound / ms:.3f}")
    return ms


def phase_c6(torch, check) -> dict:
    """Fault C6's repair: the fused training kernels at hidden widths past
    128, which they walk in chunks of 128.  #2, #3, #6, #7, #8 at F = 160
    and 448, #12 and #13 with trunk widths 160, each against its plain
    version at the production limits on the uniform draw and on the grid
    draw (B = 2,000, shared x), the NaN-of-x cases on the grid draws, each
    timed at B = 5,000; the widths past the shared memory's limit raise
    with a message that names it.  Returns {kernel: {F: ms}} (f32)."""
    from dvae_tpu_torch.ops import decoder as dec
    from dvae_tpu_torch.ops import recon as rc
    from dvae_tpu_torch.ops import zinb
    print("phase 2: C6, the fused kernels at hidden widths past 128")
    g = torch.Generator(device=DEV).manual_seed(SEED + 30)
    g_grid = torch.Generator(device=DEV).manual_seed(SEED + 31)
    cot = torch.full((A,), 1.5, device=DEV)
    times = {}

    def flat_z(out):
        return [out[0], *out[1], *out[2], *out[3]]

    for f in C6_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            item = 4 if dtype == torch.float32 else 2
            view = torch.int32 if item == 4 else torch.int16
            for on_grid in (False, True):
                tag = (f"F={f} {dname} B={TAIL} x=shared, "
                       + ("on the grid" if on_grid else "off the grid"))
                # #2 and #3
                ops = recon_inputs(torch, g_grid if on_grid else g, dtype,
                                   TAIL, False, on_grid, f=f)
                got = rc.recon_fwdbwd(*ops)
                want = rc.recon_fwdbwd_reference(*ops)
                g3 = rc.recon_bwd(cot, *ops)
                w3 = rc.recon_bwd_reference(cot, *ops)
                torch.cuda.synchronize()
                rel = ((got[0] - want[0]).abs() / want[0].abs()).max().item()
                dm = (got[1] - want[1]).abs().max().item()
                if on_grid:
                    e2 = [rel_err(torch, u, v)
                          for u, v in zip(got[2:], want[2:])]
                    e3 = [rel_err(torch, u, v) for u, v in zip(g3, w3)]
                    what = "every row and column"
                else:
                    rk, ck = recon_clear_of_kink(torch, *ops[:3])
                    e2 = recon_held_errs(torch, got[2:], want[2:], rk, ck)
                    e3 = recon_held_errs(torch, g3, w3, rk, ck)
                    what = (f"dh on the {rk.float().mean():.4f} of rows, "
                            f"dW/db on the {ck.float().mean():.4f} of "
                            f"columns with every plain |y| > {KINK_Y:.0e}")
                    del rk, ck
                check(rel <= TOL_SUMSQ[dname]
                      and dm <= TOL_MISM * TAIL * D
                      and max(e2 + e3) <= TOL_REL[dname],
                      f"{tag}: recon_fwdbwd sumsq rel err {rel:.1e}, mism "
                      f"{dm:.0f}; dh/dW/db rel err "
                      + "/".join(f"{e:.1e}" for e in e2) + "; recon_bwd "
                      + "/".join(f"{e:.1e}" for e in e3) + f" ({what}; tol "
                      f"{TOL_SUMSQ[dname]:.0e}, {TOL_REL[dname]:.0e})")
                again = rc.recon_fwdbwd(*ops)
                check(all(torch.equal(u, v) for u, v in zip(got, again))
                      and all(torch.equal(u, v) for u, v in
                              zip(g3, rc.recon_bwd(cot, *ops))),
                      f"{tag}: recon_fwdbwd, recon_bwd repeated launches "
                      "bit-identical")
                if on_grid:
                    y = torch.baddbmm(ops[2].float()[:, None, :],
                                      ops[0].float(), ops[1].float())
                    for what, at, bits in nan_of_x_cases(torch, y, False,
                                                          dtype):
                        bad = list(ops[:3]) + [ops[3].clone()]
                        bad[3].view(view)[at] = bits
                        gn = rc.recon_fwdbwd(*bad)
                        wn = rc.recon_fwdbwd_reference(*bad)
                        gn3 = rc.recon_bwd(cot, *bad)
                        wn3 = rc.recon_bwd_reference(cot, *bad)
                        check(hold_nan_pattern(torch, [gn[0], *gn[2:]],
                                               [wn[0], *wn[2:]],
                                               [got[0], *got[2:]])
                              and hold_nan_pattern(torch, gn3, wn3, g3),
                              f"{tag}: a NaN of x where {what}: recon_fwdbwd "
                              "and recon_bwd NaN where the plain version "
                              "is, every other element bit for bit")
                        del bad, gn, wn, gn3, wn3
                    del y
                del ops, got, want, g3, w3, again
                # #6, #7, #8
                zops = zinb_inputs(torch, g_grid if on_grid else g, dtype,
                                   TAIL, False, on_grid=on_grid, f=f)
                h, x = zops[0], zops[7]
                heads = tuple(zip(zops[1:7:2], zops[2:7:2]))
                held = (range(7) if on_grid
                        else [i for i in range(7) if i not in ZINB_AT_KINK])
                v = zinb.fused_zinb(*zops, ZINB_EPS)
                v0 = zinb.zinb_heads_plain(*zops, ZINB_EPS)
                fb = zinb.zinb_fwdbwd(*zops, ZINB_EPS)
                fb0 = zinb.zinb_grads_plain(*zops, ZINB_EPS)
                zc = torch.linspace(-1.5, 2.5, A, device=DEV)
                bw = zinb.zinb_bwd(zc, h, heads, x, ZINB_EPS)
                bw0 = zinb.zinb_bwd_plain(zc, h, heads, x, ZINB_EPS)
                torch.cuda.synchronize()
                e_v = ((v - v0).abs() / v0.abs()).max().item()
                e_l = ((fb[0] - fb0[0]).abs() / fb0[0].abs()).max().item()
                ef = [rel_err(torch, u, w_)
                      for u, w_ in zip(flat_z(fb[1:]), flat_z(fb0[1:]))]
                eb = [rel_err(torch, u, w_)
                      for u, w_ in zip(flat_z(bw), flat_z(bw0))]
                tol_g = TOL_ZINB_GRAD[dname]
                check(e_v <= TOL_ZINB_LOSS and e_l <= TOL_ZINB_LOSS
                      and torch.equal(v, fb[0])
                      and max(ef[i] for i in held) <= tol_g
                      and max(eb[i] for i in held) <= tol_g,
                      f"{tag}: zinb_fwd loss rel err {e_v:.1e}, equal to "
                      f"zinb_fwdbwd's {bool(torch.equal(v, fb[0]))}; "
                      f"zinb_fwdbwd loss {e_l:.1e}, gradients "
                      + "/".join(f"{ZINB_GRAD_NAMES[i]} {ef[i]:.1e}"
                                 for i in held)
                      + "; zinb_bwd " + "/".join(
                          f"{eb[i]:.1e}" for i in held)
                      + f" (tol {TOL_ZINB_LOSS:.0e}, {tol_g:.0e}"
                      + ("" if on_grid else "; dh, dW_r, db_r, which the "
                         "kink reaches: " + "/".join(
                             f"{ef[i]:.1e}" for i in ZINB_AT_KINK)) + ")")
                again = zinb.zinb_fwdbwd(*zops, ZINB_EPS)
                check(torch.equal(again[0], fb[0]) and all(
                    torch.equal(u, w_) for u, w_ in
                    zip(flat_z(again[1:]), flat_z(fb[1:]))),
                    f"{tag}: zinb_fwdbwd repeated launch bit-identical")
                del zops, h, x, heads, v, v0, fb, fb0, bw, bw0, again
                torch.cuda.empty_cache()
            # times at B = 5,000 on the uniform draw
            tag = f"F={f} {dname} B={B} x=shared"
            ops = recon_inputs(torch, g, dtype, B, False, f=f)
            nbytes = (A * B * f + A * f * D + A * D + B * D) * item
            grads = (A * B * f + A * f * D + A * D) * 4
            prod = 2.0 * A * B * f * D
            t = times.setdefault(dname, {})
            t[f"recon_fwdbwd F={f}"] = c6_time(
                torch, "recon_fwdbwd", lambda: rc.recon_fwdbwd(*ops),
                lambda: rc.recon_fwdbwd_reference(*ops), 3 * prod,
                nbytes + grads, dname, tag)
            t[f"recon_bwd F={f}"] = c6_time(
                torch, "recon_bwd", lambda: rc.recon_bwd(cot, *ops),
                lambda: rc.recon_bwd_reference(cot, *ops), 3 * prod,
                nbytes + grads, dname, tag)
            del ops
            zops = zinb_inputs(torch, g, dtype, B, False, f=f)
            zbytes = (A * B * f + 3 * A * f * D + 3 * A * D + B * D) * item
            zgrads = (A * B * f + 3 * A * f * D + 3 * A * D) * 4
            heads = tuple(zip(zops[1:7:2], zops[2:7:2]))
            t[f"zinb_fwd F={f}"] = c6_time(
                torch, "zinb_fwd", lambda: zinb.fused_zinb(*zops, ZINB_EPS),
                lambda: zinb.zinb_heads_plain(*zops, ZINB_EPS), 3 * prod,
                zbytes, dname, tag)
            t[f"zinb_fwdbwd F={f}"] = c6_time(
                torch, "zinb_fwdbwd",
                lambda: zinb.zinb_fwdbwd(*zops, ZINB_EPS),
                lambda: zinb.zinb_grads_plain(*zops, ZINB_EPS), 9 * prod,
                zbytes + zgrads, dname, tag)
            t[f"zinb_bwd F={f}"] = c6_time(
                torch, "zinb_bwd",
                lambda: zinb.zinb_bwd(cot, zops[0], heads, zops[7],
                                      ZINB_EPS),
                lambda: zinb.zinb_bwd_plain(cot, zops[0], heads, zops[7],
                                            ZINB_EPS), 9 * prod,
                zbytes + zgrads, dname, tag)
            if f == max(C6_WIDTHS):
                # no (A, B, D) tensor at any width: a call's outputs and
                # workspaces stay below one
                ops = recon_inputs(torch, g, dtype, B, False, f=f)
                limit = A * B * D * 4
                for name, fn in (
                        ("recon_fwdbwd", lambda: rc.recon_fwdbwd(*ops)),
                        ("recon_bwd", lambda: rc.recon_bwd(cot, *ops)),
                        ("zinb_fwd", lambda: zinb.fused_zinb(*zops,
                                                             ZINB_EPS)),
                        ("zinb_fwdbwd", lambda: zinb.zinb_fwdbwd(
                            *zops, ZINB_EPS)),
                        ("zinb_bwd", lambda: zinb.zinb_bwd(
                            cot, zops[0], heads, zops[7], ZINB_EPS))):
                    rise = call_rise(torch, fn)
                    check(rise < limit,
                          f"{tag}: {name} raises the peak by "
                          f"{rise / 1e6:.1f} MB (outputs and workspaces; "
                          f"limit one (A,B,D) f32 tensor, {limit / 1e6:.0f} "
                          "MB)")
                del ops
            del zops, heads
            torch.cuda.empty_cache()

    # #12 and #13 with trunk widths 160
    f = C6_TRUNK
    names = ["dz"] + [f"d{p}{6 + i}" for i in range(5) for p in "Wb"] \
        + ["dW11", "db11"]

    def flat_d(out):
        return [out[2], *(t for pair in out[3] for t in pair), out[4], out[5]]

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        item = 4 if dtype == torch.float32 else 2
        view = torch.int32 if item == 4 else torch.int16
        tol_g = TOL_DEC_GRAD[dname]
        tol_dz = tol_g if item == 4 else TOL_Y_BF16
        for on_grid in (False, True):
            tag = (f"trunk {f} {dname} B={TAIL} x=shared, "
                   + ("on the grid" if on_grid else "off the grid"))
            ops = decoder_inputs(torch, g_grid if on_grid else g, dtype,
                                 TAIL, False, on_grid, f=f)
            z, w11, b11, x = ops[0], ops[11], ops[12], ops[13]
            trunk = [(ops[1 + 2 * i], ops[2 + 2 * i]) for i in range(5)]
            sk, mk = dec.fused_decoder_mse(*ops)
            sp, mp = dec.decoder_mse_reference(*ops)
            got = dec.decoder_fwdbwd(z, trunk, w11, b11, x)
            want = dec.decoder_fwdbwd_reference(z, trunk, w11, b11, x)
            torch.cuda.synchronize()
            rel = ((sk - sp).abs() / sp.abs()).max().item()
            dm = (mk - mp).abs().max().item()
            check(rel <= TOL_SUMSQ[dname]
                  and dm <= TOL_DEC_MISM[dname] * TAIL * D
                  and torch.equal(got[0], sk) and torch.equal(got[1], mk),
                  f"{tag}: decoder_fwd sumsq rel err {rel:.1e}, mism "
                  f"{dm:.0f}; decoder_fwdbwd's sums equal decoder_fwd's bit "
                  "for bit")
            errs = [rel_err(torch, u, v) for u, v in zip(flat_d(got),
                                                         flat_d(want))]
            listed = " ".join(f"{n}={e:.1e}" for n, e in zip(names, errs))
            finite = all(bool(torch.isfinite(t).all()) for t in flat_d(got))
            if on_grid:
                check(errs[0] <= tol_dz and max(errs[1:]) <= tol_g
                      and finite,
                      f"{tag}: decoder_fwdbwd gradients rel err {listed} "
                      f"(tol dz {tol_dz:.0e}, the others {tol_g:.0e})")
            else:
                h5 = dec._trunk_forward(z, trunk)[-1].contiguous()
                rk = decoder_clear_rows(torch, z, trunk, w11, b11)
                _, ck = recon_clear_of_kink(torch, h5, w11, b11)
                e_clear = recon_held_errs(torch, [got[2], got[4], got[5]],
                                          [want[2], want[4], want[5]],
                                          rk, ck)
                what = (f"{tag}: decoder_fwdbwd dz on the "
                        f"{rk.float().mean():.4f} of rows, dW11/db11 on the "
                        f"{ck.float().mean():.4f} of columns clear of the "
                        "kink: rel err " + "/".join(
                            f"{e:.1e}" for e in e_clear)
                        + f"; over all {listed}")
                if item == 4:
                    # every row at the kink reaches every trunk dW and db,
                    # and at trunk 160 more rows lie there than at F = 100
                    # (on one draw 14%, moving dW8 by 9.3e-4 of its
                    # largest entry): the trunk's dW and db are held on
                    # the batch of the rows clear of the kink in every arm
                    # and layer, where no gate flips
                    keep = rk.all(dim=0)
                    zs, xs = z[:, keep].contiguous(), x[keep].contiguous()
                    sub = dec.decoder_fwdbwd(zs, trunk, w11, b11, xs)
                    subp = dec.decoder_fwdbwd_reference(zs, trunk, w11, b11,
                                                        xs)
                    e_sub = [rel_err(torch, u, v) for u, v in zip(
                        flat_d(sub)[1:11], flat_d(subp)[1:11])]
                    check(max(e_clear) <= tol_g and max(e_sub) <= tol_g
                          and finite,
                          what + f"; dW6..db10 on the {int(keep.sum())} "
                          "rows clear in every arm: rel err " + "/".join(
                              f"{e:.1e}" for e in e_sub)
                          + f" (tol {tol_g:.0e})")
                    del zs, xs, sub, subp
                else:
                    check(max(errs[0], *errs[11:]) <= TOL_Y_BF16
                          and max(errs[1:11]) <= tol_g and finite,
                          what + f" (tol {TOL_Y_BF16:.0e} for dz, dW11, "
                          f"db11, {tol_g:.0e} for dW6..db10)")
                del h5, rk, ck
            # pass by pass on the call's own workspaces
            kern = dec._fwdbwd_launch(z, trunk, w11, b11, x, 0.1, True)
            khs, kdh5 = kern[6], kern[7]
            phs = dec._trunk_forward(z, trunk)
            e_h = [rel_err(torch, u, v) for u, v in zip(khs, phs[1:])]
            r2 = rc.recon_fwdbwd(khs[-1], w11, b11, x)
            pdz, pdt = dec._trunk_backward([z] + khs, trunk, kdh5)
            e_b = [rel_err(torch, u, v) for u, v in zip(
                [kern[2], *(t for pair in kern[3] for t in pair)],
                [pdz, *(t for pair in pdt for t in pair)])]
            tol_h = tol_g if item == 4 else TOL_Y_BF16
            check(max(e_h) <= tol_h
                  and all(bool(torch.equal(u, v)) for u, v in zip(
                      [kern[0], kern[1], kdh5, kern[4], kern[5]], r2))
                  and e_b[0] <= tol_dz and max(e_b[1:]) <= tol_g,
                  f"{tag}: pass by pass, h1..h5 rel err "
                  + "/".join(f"{e:.1e}" for e in e_h) + f" (tol {tol_h:.0e});"
                  " sums, dh5, dW11, db11 equal recon_fwdbwd's on its own h5;"
                  " the trunk backward on its own h1..h5 and dh5: "
                  + " ".join(f"{n}={e:.1e}" for n, e in zip(names, e_b))
                  + f" (tol dz {tol_dz:.0e}, {tol_g:.0e})")
            del kern, khs, kdh5, phs, r2, pdz, pdt
            again = dec.decoder_fwdbwd(z, trunk, w11, b11, x)
            check(all(torch.equal(u, v) for u, v in
                      zip(flat_d(again), flat_d(got)))
                  and torch.equal(dec.fused_decoder_mse(*ops)[0], sk),
                  f"{tag}: repeated launches of both kernels bit-identical")
            if on_grid:
                h5 = dec._trunk_forward(z, trunk)[-1]
                y = torch.baddbmm(b11.float()[:, None, :], h5.float(),
                                  w11.float())
                del h5
                for what, at, bits in nan_of_x_cases(torch, y, False, dtype):
                    bx = x.clone()
                    bx.view(view)[at] = bits
                    tn = dec.decoder_fwdbwd(z, trunk, w11, b11, bx)
                    pn = dec.decoder_fwdbwd_reference(z, trunk, w11, b11, bx)
                    sn, _ = dec.fused_decoder_mse(*ops[:13], bx)
                    check(hold_nan_pattern(torch, [tn[0]] + flat_d(tn),
                                           [pn[0]] + flat_d(pn),
                                           [got[0]] + flat_d(got))
                          and hold_nan_pattern(torch, [sn], [tn[0]], [tn[0]]),
                          f"{tag}: a NaN of x where {what}: decoder_fwdbwd "
                          "NaN where the plain version is, decoder_fwd's "
                          "sums equal its own, every other element bit for "
                          "bit")
                    del bx, tn, pn, sn
                del y
            del ops, z, trunk, w11, b11, x, got, want, again
            torch.cuda.empty_cache()
        tag = f"trunk {f} {dname} B={B} x=shared"
        ops = decoder_inputs(torch, g, dtype, B, False, f=f)
        trunk = [(ops[1 + 2 * i], ops[2 + 2 * i]) for i in range(5)]
        dims = [C + 2, 10, f, f, f, f, D]
        macs = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
        wbytes = sum((k + 1) * n for k, n in zip(dims[:-1], dims[1:]))
        nbytes = (A * B * dims[0] + A * wbytes + B * D) * item
        t = times.setdefault(dname, {})
        t[f"decoder_fwd trunk {f}"] = c6_time(
            torch, "decoder_fwd", lambda: dec.fused_decoder_mse(*ops),
            lambda: dec.decoder_mse_reference(*ops), 2.0 * A * B * macs,
            nbytes, dname, tag)
        t[f"decoder_fwdbwd trunk {f}"] = c6_time(
            torch, "decoder_fwdbwd",
            lambda: dec.decoder_fwdbwd(ops[0], trunk, *ops[11:]),
            lambda: dec.decoder_fwdbwd_reference(ops[0], trunk, *ops[11:]),
            6.0 * A * B * macs, nbytes + (A * B * dims[0] * item
                                          + A * wbytes * 4), dname, tag)
        limit = A * B * D * 4
        for name, fn in (
                ("decoder_fwd", lambda: dec.fused_decoder_mse(*ops)),
                ("decoder_fwdbwd", lambda: dec.decoder_fwdbwd(
                    ops[0], trunk, *ops[11:]))):
            rise = call_rise(torch, fn)
            check(rise < limit,
                  f"{tag}: {name} raises the peak by {rise / 1e6:.1f} MB "
                  f"(outputs and workspaces; limit one (A,B,D) f32 tensor, "
                  f"{limit / 1e6:.0f} MB)")
        del ops, trunk
        torch.cuda.empty_cache()

    # the limits the libraries state, and past them a ValueError naming
    # the limit
    dlib = dec._lib()
    got = {"recon_fwdbwd": tuple(rc._lib_fwdbwd().recon_fwdbwd_max_f(b)
                                 for b in (0, 1)),
           "zinb_fwdbwd": tuple(zinb._lib_fwdbwd().zinb_fwdbwd_max_f(b)
                                for b in (0, 1)),
           "zinb_fwd": tuple(zinb._lib_fwd().zinb_fwd_max_f(b)
                             for b in (0, 1)),
           "decoder_fwdbwd": tuple(dlib.decoder_max_f(b, 1) for b in (0, 1)),
           "decoder_fwd": tuple(dlib.decoder_max_f(b, 0) for b in (0, 1))}
    check(got == C6_LIMITS, f"the widest F of each kernel (f32, bf16): {got} "
                            f"(the plans' twins: {C6_LIMITS})")
    for label, lim, run in (
            ("recon_fwdbwd", rc._lib_fwdbwd().recon_fwdbwd_max_f(0),
             lambda f: rc.recon_fwdbwd(*recon_inputs(
                 torch, g, torch.float32, 64, False, f=f, d=64))),
            ("zinb_fwdbwd", zinb._lib_fwdbwd().zinb_fwdbwd_max_f(0),
             lambda f: zinb.zinb_fwdbwd(
                 *[(t[..., :64] if t.shape[-1] == D else t).contiguous()
                   for t in zinb_inputs(torch, g, torch.float32, 64, False,
                                        f=f)], ZINB_EPS))):
        try:
            run(lim + 8)
            raised = ""
        except ValueError as e:
            raised = str(e)
        check(str(lim) in raised and "shared memory" in raised
              and "128" not in raised,
              f"{label}: F={lim + 8} refused by a ValueError that names the "
              f"limit {lim} and its cause ({raised!r})")
        run(lim)
        torch.cuda.synchronize()
        check(True, f"{label}: F={lim}, the limit, runs")
    print(f"  C6 times (ms), float32: {times.get('float32')}")
    print(f"  C6 times (ms), bfloat16: {times.get('bfloat16')}")
    return times


def largest_allocation(torch, fn):
    """(what ``fn`` returns, the largest single allocation it makes on the
    card in bytes), from the allocator's recorded history."""
    torch.cuda.memory._record_memory_history(
        enabled="all", context=None, stacks="python", max_entries=1_000_000)
    try:
        out = fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    return out, max((e["size"] for trace in snap["device_traces"]
                     for e in trace if e["action"] == "alloc"), default=0)


def phase_c6_path(torch, check, tmp, x, x_zinb) -> dict:
    """Fault C6 end to end: init_model(fc_dim=160) -> train (4 steps, one
    validation) -> a fresh load_model -> eval_model over 12,000 cells, in
    MSE, ZINB and fused_decoder mode at the production D, A, C and batch,
    counts set to 0 just before each run and read just after.  No single
    allocation of a run reaches one (A, B, D) f32 tensor; the peak rise is
    printed (autograd's (A, B, F) activations and the parameter-sized
    gradients grow with F).  Returns the launch counts of the six counted
    runs."""
    import numpy as np
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print(f"phase 9: C6 end to end, fc_dim={C6_FC_DIM}")
    out = {}
    n_train, n_val, n_serve = 2 * B, N_VAL, 12000
    steps = 2 * (n_train // B)
    for mode, data, flags, train_k, val_k in (
            ("MSE", x, {}, "recon_fwdbwd", "recon_fwd"),
            ("ZINB", x_zinb, {"mode": "ZINB"}, "zinb_fwdbwd", "zinb_fwd"),
            ("fused_decoder", x, {"fused_decoder": True, "fused_recon": True,
                                  "fused_encoder": True},
             "decoder_fwdbwd", "decoder_fwd")):
        tag = f"[C6 {mode}]"
        folder = os.path.join(tmp, f"c6_{mode}")
        trainer = CplMixVAE(saving_folder=folder, device=DEV, seed=SEED)
        trainer.init_model(n_arm=A, n_categories=C, input_dim=D,
                           fc_dim=C6_FC_DIM, lowD_dim=10, state_dim=2,
                           batch_size=B, epochs_per_jit=2, eval_every=2,
                           ckpt_every=2, **flags)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        path, largest = largest_allocation(torch, lambda: trainer.train(
            data[:n_train], x_val=data[n_train:n_train + n_val], n_epoch=2,
            early_stop_consensus=0, save_plots=False))
        wall = time.perf_counter() - t0
        trained = launch_counts()
        rise = torch.cuda.max_memory_allocated() - base
        want = {**dict.fromkeys(trained, 0), "encoder_fwd": steps,
                "encoder_bwd": steps, train_k: steps,
                val_k: -(-n_val // B)}
        limit = A * B * D * 4
        with open(os.path.join(folder, "metrics.jsonl")) as fh:
            rows = [json.loads(line) for line in fh]
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        print(f"  {tag} train: {steps} steps in {wall:.4f} s (cold, the "
              f"allocator's history recorded); epoch losses {losses}; peak "
              f"rise {rise / 1e6:.1f} MB")
        check(trained == want and len(losses) == 2
              and all(math.isfinite(v) for v in losses) and largest < limit
              and all(bool(torch.isfinite(v).all())
                      for layer in trainer.state.params.values()
                      for v in layer.values()),
              f"{tag} train at fc_dim={C6_FC_DIM}: launches {trained} "
              f"(expect {want}), losses finite, parameters finite, largest "
              f"allocation {largest / 1e6:.1f} MB (limit one (A,B,D) f32 "
              f"tensor, {limit / 1e6:.0f} MB)")
        out[f"c6_{mode}_training"] = trained
        server = CplMixVAE(device=DEV)
        server.load_model(path)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        res, largest = largest_allocation(
            torch, lambda: server.eval_model(data[:n_serve], batch_size=B))
        served = launch_counts()
        rise = torch.cuda.max_memory_allocated() - base
        want = {**dict.fromkeys(served, 0), val_k: -(-n_serve // B)}
        print(f"  {tag} eval_model: {n_serve} cells, consensus "
              f"{res['consensus']:.6f}, total_loss {res['total_loss']:.6g}, "
              f"peak rise {rise / 1e6:.1f} MB")
        check(served == want and server.cfg.fc_dim == C6_FC_DIM
              and np.asarray(res["pred_label"]).shape == (A, n_serve)
              and math.isfinite(res["total_loss"])
              and bool(np.all(np.isfinite(res["c_prob"])))
              and largest < limit and rise < limit,
              f"{tag} serve at fc_dim={C6_FC_DIM}: launches {served} (expect "
              f"{want}), finite results, largest allocation "
              f"{largest / 1e6:.1f} MB, peak rise {rise / 1e6:.1f} MB (limit "
              f"one (A,B,D) f32 tensor, {limit / 1e6:.0f} MB)")
        out[f"c6_{mode}_serving"] = served
        del trainer, server
        torch.cuda.empty_cache()
    return out


def phase_breakdown(torch, server, x) -> None:
    n_cells = x.shape[0]
    """Where the serving time goes: a warm eval_model run timed on the host
    clock, then one under torch.profiler with device time by kernel name
    and the device-busy share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    server.eval_model(x, batch_size=B)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"  warm eval_model: {n_cells} cells in {warm:.4f} s = "
          f"{n_cells / warm:.1f} cells/s")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.eval_model(x, batch_size=B)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages() if e.device_type == cuda),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    if not busy:
        print("  profiler: no device time recorded (not measured)")
        return
    copies = sum(k[0] for k in kernels if k[2].startswith("Memcpy"))
    warm_us = warm * 1e6
    # the profiled wall carries the profiler's own overhead; shares are
    # taken against the warm run's wall
    print(f"  profiled eval_model (wall {wall_us / 1e3:.3f} ms with profiler "
          f"overhead): device busy {busy / 1e3:.3f} ms = "
          f"{busy / warm_us:.3f} of the warm wall; copies "
          f"{copies / 1e3:.3f} ms, kernels {(busy - copies) / 1e3:.3f} ms "
          f"= {(busy - copies) / warm_us:.3f} of the warm wall")
    for t, n, name in kernels[:10]:
        print(f"    {t / 1e3:9.3f} ms {n:5d}x  {name[:90]}")


def phase_serving(torch, check, tmp):
    """Serving path end to end; returns (launch counts of the run, the
    dataset, the dataset on the card, the checkpoint it served)."""
    import numpy as np
    from dvae_tpu_torch.data.anndata_io import synthetic_dataset
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print("phase 3: serving path end to end")
    trainer = CplMixVAE(saving_folder=tmp, device=DEV, seed=SEED)
    trainer.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                       lowD_dim=10, state_dim=2, batch_size=B)
    ckpt = trainer.save_checkpoint("smoke")
    del trainer
    server = CplMixVAE(device=DEV)
    server.load_model(ckpt)
    check(server.cfg.fused_recon, "loaded model serves through the kernel")

    t0 = time.perf_counter()
    ds = synthetic_dataset(n_cells=N_CELLS, n_genes=D, n_types=C, seed=SEED)
    x = torch.as_tensor(ds.log1p).to(DEV)
    torch.cuda.synchronize()
    print(f"  synthetic dataset {tuple(x.shape)} resident on the card "
          f"({time.perf_counter() - t0:.1f} s to make)")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    t0 = time.perf_counter()
    res = server.eval_model(x, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["recon_fwd"]
    rise = torch.cuda.max_memory_allocated() - base

    print(f"  eval_model: {N_CELLS} cells in {wall:.4f} s = "
          f"{N_CELLS / wall:.1f} cells/s; consensus {res['consensus']:.6f}; "
          f"total_loss {res['total_loss']:.6g}")
    check(launches == 9, f"recon_fwd launches on the serving path: {launches} "
                         "(expect 9: one 8-batch chunk + the tail)")
    check(counts == {**dict.fromkeys(counts, 0), "recon_fwd": launches},
          f"no other kernel on the serving path: {counts}")
    limit = A * B * D * 4
    check(rise < limit, f"peak allocated rise over the resident dataset "
                        f"{rise / 1e6:.1f} MB (limit one (A,B,D) f32 "
                        f"tensor, {limit / 1e6:.0f} MB)")
    shapes = {"c_prob": (A, N_CELLS, C), "state_mu": (A, N_CELLS, 2),
              "state_logvar": (A, N_CELLS, 2), "x_low": (A, N_CELLS, 10),
              "pred_label": (A, N_CELLS), "total_loss_rec": (A,)}
    for k, shp in shapes.items():
        v = np.asarray(res[k])
        check(v.shape == shp and bool(np.all(np.isfinite(v))),
              f"{k}: shape {v.shape}, finite")
    lab = res["pred_label"]
    check(bool(lab.min() >= 0 and lab.max() < C), "labels in [0, C)")
    check(0.0 <= res["consensus"] <= 1.0 and math.isfinite(res["total_loss"]),
          "consensus in [0, 1], total loss finite")

    phase_breakdown(torch, server, x)
    serving_parity(check, server, ckpt, ds.log1p[:N_SMALL], x[:N_SMALL])
    return counts, ds, x, ckpt


def _recon_err(got, want) -> float:
    import numpy as np
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _served_within_limits(check, got, want, what: str,
                          loss: str = "loss_rec") -> None:
    """The serving limits of PERF.md §2 on two result dicts of eval_model or
    generate: labels agree on ≥ 0.999 of the cells, c_prob (on the agreeing
    cells) and state_mu within 1e-3, the per-arm reconstruction loss
    (``loss``) within 1e-3 relative, recon within 1e-4 of its largest
    entry; each where both dicts hold it."""
    import numpy as np
    agree = got["pred_label"] == want["pred_label"]
    check(float(agree.mean()) >= 0.999,
          f"{what}: labels agree on {float(agree.mean()):.6f} (min 0.999)")
    rows = np.all(agree, axis=0)
    dc = float(np.abs(got["c_prob"][:, rows] - want["c_prob"][:, rows]).max())
    check(dc <= 1e-3, f"{what}: c_prob max abs diff {dc:.2e} (tol 1e-3)")
    dmu = float(np.abs(got["state_mu"] - want["state_mu"]).max())
    check(dmu <= 1e-3, f"{what}: state_mu max abs diff {dmu:.2e} (tol 1e-3)")
    if loss in got and loss in want:
        rl = float(np.max(np.abs(got[loss] - want[loss]) / np.abs(want[loss])))
        check(rl <= 1e-3, f"{what}: {loss} max rel diff {rl:.2e} (tol 1e-3)")
    if "recon" in got and "recon" in want:
        dr = _recon_err(got["recon"], want["recon"])
        check(dr <= 1e-4, f"{what}: recon max|Δ|/max|recon| {dr:.2e} "
                          "(tol 1e-4)")


def serving_parity(check, server, ckpt, small, small_dev,
                   aug_file=None) -> None:
    """One served batch on the card against the port's CPU path (plain
    PyTorch) from the same checkpoint (and the same augmenter: eval draws
    its noise from a CPU generator on either device)."""
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    ref = CplMixVAE(device="cpu", aug_file=aug_file)
    ref.load_model(ckpt)
    want = ref.eval_model(small, batch_size=B)
    got = server.eval_model(small_dev, batch_size=B)
    _served_within_limits(check, got, want,
                          f"served vs CPU path on {small.shape[0]} cells",
                          loss="total_loss_rec")


def phase_parity_step(torch, check, path, x, aug_file=None) -> None:
    """One train step from the same checkpoint with the same explicit noise
    (the augmenter's included) on the card (kernels) and on the CPU (plain
    versions)."""
    import numpy as np
    from dvae_tpu_torch.augment.augmenter import AugNoise
    from dvae_tpu_torch.models.mixvae import Noise
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    from dvae_tpu_torch.train.step import make_train_step
    gpu = CplMixVAE(device=DEV, aug_file=aug_file)
    cpu = CplMixVAE(device="cpu", aug_file=aug_file)
    gpu.load_model(path)
    cpu.load_model(path)
    rng = np.random.default_rng(SEED)
    n, s_keep = N_PARITY, 1 - gpu.cfg.s_drop
    noise = Noise(
        x_mask=torch.from_numpy(rng.random((A, n, D), np.float32) < 1 - RATE),
        gumbel_u=torch.from_numpy(rng.random((A, n, C), np.float32)),
        reparam_e=torch.from_numpy(rng.standard_normal((A, n, 2), np.float32)),
        s_mask=torch.from_numpy(rng.random((A, n, 2), np.float32) < s_keep))
    xb = x[:n].contiguous()
    draws = None
    if aug_file:
        acfg = gpu._aug_loaded[2]
        draws = AugNoise(
            z=torch.from_numpy(rng.standard_normal((A, n, acfg.noise_dim),
                                                   np.float32)),
            e=torch.from_numpy(rng.standard_normal((A, n, acfg.latent_dim),
                                                   np.float32)))

    def on(dev, bundle):
        return None if bundle is None else type(bundle)(
            *(None if t is None else t.to(dev) for t in bundle))

    sg, mg, _ = make_train_step(gpu.cfg, gpu.tcfg, gpu.tx,
                                gpu._augment_fn())(
        gpu.state, xb, None, 1.0, noise=on(DEV, noise),
        aug_draws=on(DEV, draws))
    sc, mc, _ = make_train_step(cpu.cfg, cpu.tcfg, cpu.tx,
                                cpu._augment_fn())(
        cpu.state, xb.cpu(), None, 1.0, noise=noise, aug_draws=draws)
    lg, lc = mg.total.item(), mc.total.item()
    rel = abs(lg - lc) / abs(lc)
    check(rel <= 1e-4, f"one step, {n} cells, card vs CPU path: loss "
                       f"{lg:.6g} vs {lc:.6g}, rel {rel:.2e} (tol 1e-4)")
    dmax, n_far, n_all = 0.0, 0, 0
    for name in sg.params:
        for leaf in sg.params[name]:
            d = (sg.params[name][leaf].cpu() - sc.params[name][leaf]).abs()
            dmax = max(dmax, d.max().item())
            n_far += int((d > 1e-5).sum())
            n_all += d.numel()
    check(dmax <= 2 * LR and n_far <= 1e-3 * n_all,
          f"parameters after Adam, card vs CPU: max |diff| {dmax:.2e} "
          f"(tol 2*lr = {2 * LR:.0e}), {n_far} of {n_all} entries beyond "
          f"1e-5 (tol 0.1%)")


def warm_chunk_ms(torch, trainer, x_train, chunks: int = 1) -> float:
    """Warm ms/step of 2-epoch chunks of ``trainer``'s training path, its
    augmenter included (the state trains on; the first chunk is not
    timed)."""
    from dvae_tpu_torch.train.step import make_epoch_runner
    n_train = x_train.shape[0]
    run = make_epoch_runner(trainer.cfg, trainer.tcfg, trainer.tx, n_train,
                            epochs_per_chunk=2,
                            augment=trainer._augment_fn())
    steps = 2 * (n_train // B)
    state, ems = run(trainer.state, x_train, None, 1.0)
    ems.total.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        state, ems = run(state, x_train, None, 1.0)
        ems.total.cpu()
    return (time.perf_counter() - t0) / (chunks * steps) * 1e3


def phase_chunk_breakdown(torch, trainer, x_train, top: int = 12) -> tuple:
    """Warm throughput of one 2-epoch chunk, its synchronising calls, and
    a torch.profiler breakdown by kernel name.  Returns (synchronising
    calls, [(device µs, count, kernel name)], device-busy µs)."""
    n_train = x_train.shape[0]
    from torch.profiler import ProfilerActivity, profile
    from dvae_tpu_torch.train.step import make_epoch_runner
    run = make_epoch_runner(trainer.cfg, trainer.tcfg, trainer.tx, n_train,
                            epochs_per_chunk=2,
                            augment=trainer._augment_fn())
    steps = 2 * (n_train // B)
    warm = warm_chunk_ms(torch, trainer, x_train) * steps / 1e3
    state = trainer.state
    print(f"  warm chunk: {steps} steps in {warm:.4f} s = "
          f"{steps * B / warm:.1f} cells/s, {warm / steps * 1e3:.3f} ms/step")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, ems = run(state, x_train, None, 1.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n_sync = sum("called a synchronizing" in str(w.message) for w in caught)
    ems.total.cpu()
    print(f"  synchronising calls inside one chunk: {n_sync}")
    for w in caught[:3]:
        print(f"    {str(w.message)[:100]} ({os.path.basename(w.filename)}"
              f":{w.lineno})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, ems = run(state, x_train, None, 1.0)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages() if e.device_type == cuda),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    if not busy:
        print("  profiler: no device time recorded (not measured)")
        return n_sync, [], 0
    print(f"  profiled chunk: device busy {busy / 1e3:.3f} ms = "
          f"{busy / (warm * 1e6):.3f} of the warm chunk's wall "
          f"({busy / 1e3 / steps:.3f} ms/step)")
    for t, n, name in kernels[:top]:
        print(f"    {t / 1e3:9.3f} ms {n:5d}x  {name[:90]}")
    return n_sync, kernels, busy


def phase_training(torch, check, tmp, x) -> dict:
    """Training path end to end; returns the launch counts of the run."""
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print("phase 4: training path end to end")
    folder = os.path.join(tmp, "train")
    trainer = CplMixVAE(saving_folder=folder, device=DEV, seed=SEED)
    trainer.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                       lowD_dim=10, state_dim=2, batch_size=B,
                       epochs_per_jit=2, eval_every=2, ckpt_every=2)
    check(trainer.cfg.fused_encoder and trainer.cfg.fused_recon,
          "the kernels are on by default on CUDA")
    x_train, x_val = x[:N_TRAIN], x[N_TRAIN:N_TRAIN + N_VAL]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    path = trainer.train(x_train, x_val=x_val, n_epoch=4,
                         early_stop_consensus=0, save_plots=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    rise = torch.cuda.max_memory_allocated() - base
    steps = 4 * (N_TRAIN // B)
    print(f"  train: 4 epochs, {steps} steps, {N_TRAIN} cells, 2 validations "
          f"in {wall:.4f} s (cold, checkpoints included)")
    want = {**dict.fromkeys(counts, 0), "encoder_fwd": steps,
            "encoder_bwd": steps, "recon_fwdbwd": steps, "recon_fwd": 2}
    check(counts == want, f"launches on the training path: {counts} "
                          f"(expect {want})")
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    print(f"  epoch losses: {losses}")
    check(len(losses) == 4 and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0],
          "loss finite, last epoch's mean below the first's")
    val = [r for r in rows if "val/loss" in r]
    check(len(val) == 2 and all(math.isfinite(r["val/loss"]) for r in val),
          f"2 validations with finite loss ({len(val)})")
    limit = A * B * D * 4
    check(rise < limit, f"peak allocated rise over the resident dataset "
                        f"{rise / 1e6:.1f} MB (limit one (A,B,D) f32 "
                        f"tensor, {limit / 1e6:.0f} MB)")
    p = trainer.state.params
    check(all(bool(torch.isfinite(v).all()) for layer in p.values()
              for v in layer.values()), "parameters finite")

    resumed = CplMixVAE(saving_folder=os.path.join(tmp, "resume"),
                        device=DEV)
    epoch = resumed.load_model(path)
    resumed.train(x_train, n_epoch=2, early_stop_consensus=0,
                  save_plots=False)
    check(epoch == 4 and resumed.state.epoch == 6
          and resumed.state.opt_state.count == 6 * (N_TRAIN // B),
          f"resume from {os.path.basename(path)}: epoch {epoch} -> "
          f"{resumed.state.epoch}, Adam steps "
          f"{resumed.state.opt_state.count}")
    phase_parity_step(torch, check, path, x)
    phase_chunk_breakdown(torch, resumed, x_train)
    del trainer, resumed
    torch.cuda.empty_cache()
    return counts


def phase_zinb_path(torch, check, tmp) -> tuple:
    """ZINB mode end to end at full width: training, resume, serving, the
    card against the CPU path.  Returns ({"training": counts, "serving":
    counts} of the two counted runs, the dataset on the card)."""
    import numpy as np
    from dvae_tpu_torch.data.anndata_io import hard_synthetic_dataset
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print("phase 5: ZINB mode end to end")
    n_cells = N_ZINB_TRAIN + N_ZINB_VAL
    t0 = time.perf_counter()
    ds = hard_synthetic_dataset(n_cells=n_cells, n_genes=D, n_types=C,
                                seed=SEED, device=DEV)
    x = torch.as_tensor(ds.log1p).to(DEV)
    torch.cuda.synchronize()
    zeros = float((x == 0).float().mean())
    print(f"  hard synthetic counts {tuple(x.shape)}, {ds.n_type} types, "
          f"{zeros:.3f} zeros, max {float(x.max()):.2f}, resident on the "
          f"card ({time.perf_counter() - t0:.1f} s to make)")
    check(ds.n_type == C and 0.3 < zeros < 0.95 and bool(
        torch.isfinite(x).all()), "the data are sparse, finite counts of "
                                  f"{C} types")

    folder = os.path.join(tmp, "zinb")
    trainer = CplMixVAE(saving_folder=folder, device=DEV, seed=SEED)
    trainer.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                       lowD_dim=10, state_dim=2, mode="ZINB", batch_size=B,
                       epochs_per_jit=2, eval_every=2, ckpt_every=2)
    check(trainer.cfg.mode == "ZINB" and trainer.cfg.fused_encoder
          and trainer.cfg.fused_recon,
          "ZINB mode with the kernels on by default on CUDA")
    x_train, x_val = x[:N_ZINB_TRAIN], x[N_ZINB_TRAIN:]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    path = trainer.train(x_train, x_val=x_val, n_epoch=4,
                         early_stop_consensus=0, save_plots=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trained = launch_counts()
    rise = torch.cuda.max_memory_allocated() - base
    steps = 4 * (N_ZINB_TRAIN // B)
    print(f"  train: 4 epochs, {steps} steps, {N_ZINB_TRAIN} cells, 2 "
          f"validations in {wall:.4f} s (cold, checkpoints included)")
    want = {**dict.fromkeys(trained, 0), "encoder_fwd": steps,
            "encoder_bwd": steps, "zinb_fwdbwd": steps, "zinb_fwd": 2}
    check(trained == want, f"launches on the ZINB training path: {trained} "
                           f"(expect {want})")
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    rec = [float(np.mean([r[f"train/rec_loss_arm{a}"] for a in range(A)]))
           for r in rows if "train/loss" in r]
    print(f"  epoch losses: {losses}")
    print(f"  epoch mean rec_nll over arms: {rec}")
    check(len(losses) == 4 and all(math.isfinite(v) for v in losses + rec)
          and rec[-1] < rec[0],
          "loss finite, last epoch's mean rec_nll below the first's")
    val = [r for r in rows if "val/loss" in r]
    check(len(val) == 2 and all(
        math.isfinite(r["val/loss"]) and math.isfinite(r["val/rec_loss_arm0"])
        for r in val), f"2 validations with finite loss ({len(val)})")
    limit = A * B * D * 4
    check(rise < limit, f"peak allocated rise over the resident dataset "
                        f"{rise / 1e6:.1f} MB (limit one (A,B,D) f32 "
                        f"tensor, {limit / 1e6:.0f} MB; the ZINB kernels "
                        "take no workspace beyond their block partials)")
    check(all(bool(torch.isfinite(v).all())
              for layer in trainer.state.params.values()
              for v in layer.values()), "parameters finite")

    resumed = CplMixVAE(saving_folder=os.path.join(tmp, "zinb_resume"),
                        device=DEV)
    epoch = resumed.load_model(path)
    final = resumed.train(x_train, n_epoch=2, early_stop_consensus=0,
                          save_plots=False)
    per_epoch = N_ZINB_TRAIN // B
    check(epoch == 4 and resumed.state.epoch == 6
          and resumed.state.opt_state.count == 6 * per_epoch
          and resumed.cfg.mode == "ZINB",
          f"resume from {os.path.basename(path)}: epoch {epoch} -> "
          f"{resumed.state.epoch}, Adam steps "
          f"{resumed.state.opt_state.count}")

    server = CplMixVAE(device=DEV)
    server.load_model(final)
    check(server.cfg.mode == "ZINB" and server.cfg.fused_recon,
          "a fresh instance serves the ZINB checkpoint through the kernel")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = server.eval_model(x, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = launch_counts()
    rise = torch.cuda.max_memory_allocated() - base
    n_launch = -(-n_cells // B)
    print(f"  eval_model: {n_cells} cells in {wall:.4f} s = "
          f"{n_cells / wall:.1f} cells/s; consensus {res['consensus']:.6f}; "
          f"rec_nll {np.asarray(res['total_loss_rec'])}")
    check(served == {**dict.fromkeys(served, 0), "zinb_fwd": n_launch},
          f"launches on the ZINB serving path: {served} (expect zinb_fwd "
          f"{n_launch}: one {n_cells // B}-batch chunk + the tail)")
    check(rise < limit, f"serving peak allocated rise {rise / 1e6:.1f} MB "
                        f"(limit {limit / 1e6:.0f} MB)")
    shapes = {"c_prob": (A, n_cells, C), "state_mu": (A, n_cells, 2),
              "x_low": (A, n_cells, 10), "pred_label": (A, n_cells),
              "total_loss_rec": (A,)}
    for k, shp in shapes.items():
        v = np.asarray(res[k])
        check(v.shape == shp and bool(np.all(np.isfinite(v))),
              f"{k}: shape {v.shape}, finite")
    check(0.0 <= res["consensus"] <= 1.0 and math.isfinite(res["total_loss"]),
          "consensus in [0, 1], total loss finite")

    phase_breakdown(torch, server, x)
    serving_parity(check, server, final, ds.log1p[:N_SMALL], x[:N_SMALL])
    phase_parity_step(torch, check, final, x)
    phase_chunk_breakdown(torch, resumed, x_train)
    del trainer, resumed, server
    torch.cuda.empty_cache()
    return {"training": trained, "serving": served}, x


def alignment_invariance(torch, check, trainer, xb) -> None:
    """One alignment move on a copy of the trainer's state: the eval loss of
    one batch before and after the permutation."""
    import numpy as np
    from dvae_tpu_torch.train.alignment import (align_state, moved_counts,
                                                permute_categories,
                                                permute_opt_state)
    from dvae_tpu_torch.train.step import make_eval_step
    ev = make_eval_step(trainer.cfg, trainer.tcfg)
    state = trainer.state
    before, lab, _ = ev(state, xb, None, 1.0)
    # rotate arm 1's categories first, so that there is something to undo
    # whatever the training run left
    m_rot = np.tile(np.arange(C), (A, 1))
    m_rot[1] = np.roll(m_rot[1], 5)
    rotated = state._replace(
        params=permute_categories(state.params, m_rot, trainer.cfg),
        opt_state=permute_opt_state(state.opt_state, m_rot, trainer.cfg))
    mid, lab_rot, _ = ev(rotated, xb, None, 1.0)
    lab_np = lab.cpu().numpy()
    check(bool(np.array_equal(lab_rot.cpu().numpy(),
                              np.take_along_axis(m_rot, lab_np, axis=1))),
          "a rotation of arm 1's category indices renames its labels: "
          "new = m[a, old]")
    aligned, m, moved = align_state(rotated, lab_rot.cpu().numpy(),
                                    trainer.cfg,
                                    mask=state.mask.cpu().numpy())
    after, lab_new, _ = ev(aligned, xb, None, 1.0)
    _, active = moved_counts(m, lab_rot.cpu().numpy())

    def rel(u, v):
        return ((u - v).abs() / v.abs().clamp_min(1e-30)).max().item()

    e_rec = max(rel(mid.loss_rec, before.loss_rec),
                rel(after.loss_rec, before.loss_rec))
    e_kl = max(rel(mid.kl, before.kl), rel(after.kl, before.kl))
    e_ent = max(rel(mid.neg_entropy, before.neg_entropy),
                rel(after.neg_entropy, before.neg_entropy))
    check(moved > 0 and e_rec <= 1e-5 and e_kl <= 1e-5 and e_ent <= 1e-5,
          f"alignment on one batch: {moved} indices remapped ({active} "
          f"active); per-arm loss_rec, KL and entropy unchanged by the "
          f"rotation and by the alignment (max rel diff {e_rec:.1e}, "
          f"{e_kl:.1e}, {e_ent:.1e}; tol 1e-5: the same sums, the "
          "categories in another order)")
    d0, d1, d2 = (v.c_dist.item() for v in (before, mid, after))
    check(d2 <= d1 * (1 + 1e-5),
          f"coupling term: {d0:.6g} as trained, {d1:.6g} with arm 1 "
          f"rotated, {d2:.6g} after the alignment (not larger than "
          "before it)")
    mu0 = state.opt_state.mu["fcc"]["b"]
    mu2 = aligned.opt_state.mu["fcc"]["b"]
    check(aligned.opt_state.count == state.opt_state.count
          and bool(torch.equal(mu2.sort(dim=1).values,
                               mu0.sort(dim=1).values)),
          "the Adam moments moved with their categories (fcc.b's first "
          "moment per arm: the same values in another order)")


def phase_categorical_path(torch, check, tmp, x, x_zinb) -> dict:
    """The categorical path end to end at full width: use_pallas (the fused
    Gumbel sampler and coupling distance) with cross-arm alignment, in MSE
    mode through training, a fresh load and serving, then a short ZINB
    run.  Returns {"training", "serving", "zinb"}: the launch counts of
    the three counted runs, and "checkpoint": the trained use_pallas
    checkpoint (phase 12 serves it again)."""
    import numpy as np
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print("phase 6: use_pallas + alignment end to end")
    folder = os.path.join(tmp, "categorical")
    trainer = CplMixVAE(saving_folder=folder, device=DEV, seed=SEED)
    trainer.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                       lowD_dim=10, state_dim=2, batch_size=B,
                       epochs_per_jit=2, eval_every=2, ckpt_every=2,
                       use_pallas=True, align_arms_every=2)
    check(trainer.cfg.use_pallas and trainer.cfg.fused_encoder
          and trainer.cfg.fused_recon and trainer.tcfg.align_arms_every == 2,
          "use_pallas and align_arms_every are taken; the default kernels "
          "stay on")
    x_train = x[:N_CAT_TRAIN]
    x_val = x[N_CAT_TRAIN:N_CAT_TRAIN + N_CAT_VAL]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    path = trainer.train(x_train, x_val=x_val, n_epoch=4,
                         early_stop_consensus=0, save_plots=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trained = launch_counts()
    rise = torch.cuda.max_memory_allocated() - base
    per_epoch = N_CAT_TRAIN // B
    steps = 4 * per_epoch
    n_val, n_align = 2, 2
    # an eval batch computes the loss: one coupling and one recon_fwd for
    # each validation batch and each _predict_labels batch of an alignment
    # (min(N, 4·batch) cells in batches of batch_size)
    eval_batches = (n_val * -(-N_CAT_VAL // B)
                    + n_align * (min(N_CAT_TRAIN, 4 * B) // B))
    print(f"  train: 4 epochs, {steps} steps, {N_CAT_TRAIN} cells, {n_val} "
          f"validations, {n_align} alignments in {wall:.4f} s (cold, "
          "checkpoints included)")
    want = {**dict.fromkeys(trained, 0), "encoder_fwd": steps,
            "encoder_bwd": steps, "recon_fwdbwd": steps,
            "gumbel_fwd": steps, "gumbel_bwd": steps,
            "coupling": steps + eval_batches, "recon_fwd": eval_batches}
    check(trained == want, f"launches on the categorical training path: "
                           f"{trained} (expect {want})")
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    print(f"  epoch losses: {losses}")
    check(len(losses) == 4 and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0],
          "loss finite, last epoch's mean below the first's")
    val = [r for r in rows if "val/loss" in r]
    check(len(val) == n_val and all(math.isfinite(r["val/loss"])
                                    for r in val),
          f"{n_val} validations with finite loss ({len(val)})")
    moves = [r for r in rows if "train/align_moved" in r]
    check(len(moves) >= 1 and all(r["train/align_moved"] > 0 for r in moves),
          f"the [align] move happened {len(moves)} time(s): "
          + ", ".join(f"{r['train/align_moved']} indices "
                      f"({r['train/align_moved_active']} active), consensus "
                      f"{r['train/align_consensus']:.3f}" for r in moves))
    limit = A * B * D * 4
    check(rise < limit, f"peak allocated rise over the resident dataset "
                        f"{rise / 1e6:.1f} MB (limit one (A,B,D) f32 "
                        f"tensor, {limit / 1e6:.0f} MB)")
    check(all(bool(torch.isfinite(v).all())
              for layer in trainer.state.params.values()
              for v in layer.values()), "parameters finite")
    alignment_invariance(torch, check, trainer, x_val)

    server = CplMixVAE(device=DEV)
    epoch = server.load_model(path)
    check(epoch == 4 and server.cfg.use_pallas and server.cfg.fused_recon
          and server.tcfg.align_arms_every == 2,
          "a fresh instance takes use_pallas and align_arms_every from the "
          "checkpoint")
    n_cells = N_CAT_TRAIN + N_CAT_VAL
    reset_launch_counts()
    t0 = time.perf_counter()
    res = server.eval_model(x[:n_cells], batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = launch_counts()
    n_launch = -(-n_cells // B)
    print(f"  eval_model: {n_cells} cells in {wall:.4f} s = "
          f"{n_cells / wall:.1f} cells/s; consensus {res['consensus']:.6f}; "
          f"total_loss {res['total_loss']:.6g}")
    check(served == {**dict.fromkeys(served, 0), "coupling": n_launch,
                     "recon_fwd": n_launch},
          f"launches on the categorical serving path: {served} (expect "
          f"coupling and recon_fwd {n_launch} each: one per eval batch, "
          "where the loss is computed)")
    check(np.asarray(res["pred_label"]).shape == (A, n_cells)
          and math.isfinite(res["total_loss"])
          and bool(np.all(np.isfinite(res["c_prob"])))
          and 0.0 <= res["consensus"] <= 1.0,
          "labels of every cell, finite posteriors and loss, consensus in "
          "[0, 1]")
    serving_parity(check, server, path, x[:N_SMALL].cpu().numpy(),
                   x[:N_SMALL])
    phase_parity_step(torch, check, path, x)

    # with and without use_pallas from the same checkpoint, in turns
    plain = CplMixVAE(device=DEV)
    plain.load_model(path)
    plain.cfg = plain.cfg.replace(use_pallas=False)
    fused = CplMixVAE(device=DEV)
    fused.load_model(path)
    ms = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        ms[which].append(warm_chunk_ms(
            torch, plain if which == "off" else fused, x_train, chunks=2))
    off, on = (sum(ms[k]) / 2 for k in ("off", "on"))
    print(f"  warm training step without use_pallas {off:.3f} ms "
          f"({ms['off'][0]:.3f}, {ms['off'][1]:.3f}) = {B / off * 1e3:.1f} "
          f"cells/s; with use_pallas {on:.3f} ms ({ms['on'][0]:.3f}, "
          f"{ms['on'][1]:.3f}) = {B / on * 1e3:.1f} cells/s")
    n_sync, kernels, busy = phase_chunk_breakdown(torch, fused, x_train)
    check(n_sync == 0, f"{n_sync} synchronising calls inside a use_pallas "
                       "chunk (expect 0)")
    ours = [(t, n, name) for t, n, name in kernels
            if "gumbel_" in name or "coupling_" in name
            or name.startswith("reduce_partials")]
    if busy:
        steps_prof = 2 * per_epoch
        share = sum(k[0] for k in ours) / busy
        print(f"  the Gumbel and coupling kernels in the profiled chunk: "
              f"{sum(k[0] for k in ours) / 1e3 / steps_prof:.4f} ms/step = "
              f"{share:.4f} of the device time")
        for t, n, name in ours:
            print(f"    {t / 1e3:9.3f} ms {n:5d}x  {name[:90]}")
    del trainer, server, plain, fused
    torch.cuda.empty_cache()

    # ZINB mode with use_pallas: the flag composes with the ZINB kernels
    ztrainer = CplMixVAE(saving_folder=os.path.join(tmp, "categorical_zinb"),
                         device=DEV, seed=SEED)
    ztrainer.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                        lowD_dim=10, state_dim=2, mode="ZINB", batch_size=B,
                        epochs_per_jit=2, use_pallas=True, hard=True)
    reset_launch_counts()
    ztrainer.train(x_zinb[:N_CAT_ZINB], n_epoch=2, early_stop_consensus=0,
                   save_plots=False)
    torch.cuda.synchronize()
    zinb = launch_counts()
    zsteps = 2 * (N_CAT_ZINB // B)
    want = {**dict.fromkeys(zinb, 0), "encoder_fwd": zsteps,
            "encoder_bwd": zsteps, "zinb_fwdbwd": zsteps,
            "gumbel_fwd": zsteps, "gumbel_bwd": zsteps, "coupling": zsteps}
    check(zinb == want and not ztrainer._halted,
          f"launches of a ZINB run with use_pallas and hard samples: {zinb} "
          f"(expect {want})")
    del ztrainer
    torch.cuda.empty_cache()
    return {"training": trained, "serving": served, "zinb": zinb,
            "checkpoint": path}


def phase_wide_categories(torch, check, tmp, x) -> dict:
    """Fault C7 end to end: init_model(use_pallas=True, align_arms_every=2,
    n_categories=N_CAT_WIDE) -> train (4 steps, one alignment, one
    validation) -> a fresh load_model -> eval_model over 12,000 cells, at
    the production A, D, F and batch, counts set to 0 just before each run
    and read just after.  Rows of N_CAT_WIDE categories are wider than #10
    keeps in registers (512 columns).  Losses finite; no single allocation
    of either run reaches one (A, B, D) f32 tensor.  Returns the launch
    counts of the two runs."""
    import numpy as np
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print(f"phase 6b: C7 end to end, n_categories={N_CAT_WIDE}")
    tag = f"[C7 n_categories={N_CAT_WIDE}]"
    folder = os.path.join(tmp, "categorical_wide")
    trainer = CplMixVAE(saving_folder=folder, device=DEV, seed=SEED)
    trainer.init_model(n_arm=A, n_categories=N_CAT_WIDE, input_dim=D,
                       fc_dim=F, lowD_dim=10, state_dim=2, batch_size=B,
                       epochs_per_jit=2, eval_every=2, ckpt_every=2,
                       use_pallas=True, align_arms_every=2)
    n_train, n_val, n_serve = 2 * B, N_VAL, 12000
    steps = 2 * (n_train // B)
    # one validation batch and the alignment's min(N, 4·batch) cells, each
    # batch one coupling and one recon_fwd
    eval_batches = -(-n_val // B) + min(n_train, 4 * B) // B
    limit = A * B * D * 4
    reset_launch_counts()
    t0 = time.perf_counter()
    path, largest = largest_allocation(torch, lambda: trainer.train(
        x[:n_train], x_val=x[n_train:n_train + n_val], n_epoch=2,
        early_stop_consensus=0, save_plots=False))
    wall = time.perf_counter() - t0
    trained = launch_counts()
    want = {**dict.fromkeys(trained, 0), "encoder_fwd": steps,
            "encoder_bwd": steps, "recon_fwdbwd": steps,
            "gumbel_fwd": steps, "gumbel_bwd": steps,
            "coupling": steps + eval_batches, "recon_fwd": eval_batches}
    with open(os.path.join(folder, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    val = [r["val/loss"] for r in rows if "val/loss" in r]
    print(f"  {tag} train: {steps} steps in {wall:.4f} s (cold, the "
          f"allocator's history recorded); epoch losses {losses}; "
          f"validation {val}")
    check(trained == want and len(losses) == 2 and len(val) == 1
          and all(math.isfinite(v) for v in losses + val)
          and largest < limit and not trainer._halted
          and all(bool(torch.isfinite(v).all())
                  for layer in trainer.state.params.values()
                  for v in layer.values()),
          f"{tag} train: launches {trained} (expect {want}), losses and "
          f"validation finite, parameters finite, largest allocation "
          f"{largest / 1e6:.1f} MB (limit one (A,B,D) f32 tensor, "
          f"{limit / 1e6:.0f} MB)")
    server = CplMixVAE(device=DEV)
    server.load_model(path)
    reset_launch_counts()
    res, largest = largest_allocation(
        torch, lambda: server.eval_model(x[:n_serve], batch_size=B))
    served = launch_counts()
    n_launch = -(-n_serve // B)
    want = {**dict.fromkeys(served, 0), "coupling": n_launch,
            "recon_fwd": n_launch}
    print(f"  {tag} eval_model: {n_serve} cells, consensus "
          f"{res['consensus']:.6f}, total_loss {res['total_loss']:.6g}")
    check(served == want and server.cfg.n_categories == N_CAT_WIDE
          and np.asarray(res["pred_label"]).shape == (A, n_serve)
          and math.isfinite(res["total_loss"])
          and bool(np.all(np.isfinite(res["c_prob"])))
          and largest < limit,
          f"{tag} serve: launches {served} (expect {want}), finite results, "
          f"largest allocation {largest / 1e6:.1f} MB (limit "
          f"{limit / 1e6:.0f} MB)")
    del trainer, server
    torch.cuda.empty_cache()
    return {"c7_training": trained, "c7_serving": served}


def phase_many_arms(torch, check, tmp, x) -> dict:
    """Fault C8 end to end: init_model(use_pallas=True, align_arms_every=2,
    n_arm=N_ARM_WIDE) -> train (4 steps, one alignment, one validation) ->
    a fresh load_model -> eval_model over 12,000 cells, at the production
    D, F, C and batch, counts set to 0 just before each run and read just
    after.  Every coupling call runs #11's general kernel (more than 10
    arms).  Losses finite; no single allocation reaches one (A, B, D) f32
    tensor of the 12 arms.  Returns the launch counts of the two runs."""
    import numpy as np
    from dvae_tpu_torch.ops import coupling as cp
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    arms = N_ARM_WIDE
    print(f"phase 6c: C8 end to end, n_arm={arms}")
    tag = f"[C8 n_arm={arms}]"
    check(cp.coupling_plan(arms, B, C)["general"],
          f"{tag}: #11 runs its general kernel at ({arms}, {B}, {C})")
    folder = os.path.join(tmp, "categorical_arms")
    trainer = CplMixVAE(saving_folder=folder, device=DEV, seed=SEED)
    trainer.init_model(n_arm=arms, n_categories=C, input_dim=D, fc_dim=F,
                       lowD_dim=10, state_dim=2, batch_size=B,
                       epochs_per_jit=2, eval_every=2, ckpt_every=2,
                       use_pallas=True, align_arms_every=2)
    n_train, n_val, n_serve = 2 * B, N_VAL, 12000
    steps = 2 * (n_train // B)
    eval_batches = -(-n_val // B) + min(n_train, 4 * B) // B
    limit = arms * B * D * 4
    reset_launch_counts()
    t0 = time.perf_counter()
    path, largest = largest_allocation(torch, lambda: trainer.train(
        x[:n_train], x_val=x[n_train:n_train + n_val], n_epoch=2,
        early_stop_consensus=0, save_plots=False))
    wall = time.perf_counter() - t0
    trained = launch_counts()
    want = {**dict.fromkeys(trained, 0), "encoder_fwd": steps,
            "encoder_bwd": steps, "recon_fwdbwd": steps,
            "gumbel_fwd": steps, "gumbel_bwd": steps,
            "coupling": steps + eval_batches, "recon_fwd": eval_batches}
    with open(os.path.join(folder, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    val = [r["val/loss"] for r in rows if "val/loss" in r]
    moves = [r for r in rows if "train/align_moved" in r]
    print(f"  {tag} train: {steps} steps in {wall:.4f} s (cold, the "
          f"allocator's history recorded); epoch losses {losses}; "
          f"validation {val}; alignments {len(moves)}")
    check(trained == want and len(losses) == 2 and len(val) == 1
          and all(math.isfinite(v) for v in losses + val)
          and largest < limit and not trainer._halted
          and all(bool(torch.isfinite(v).all())
                  for layer in trainer.state.params.values()
                  for v in layer.values()),
          f"{tag} train: launches {trained} (expect {want}), losses and "
          f"validation finite, parameters finite, largest allocation "
          f"{largest / 1e6:.1f} MB (limit one (A,B,D) f32 tensor, "
          f"{limit / 1e6:.0f} MB)")
    server = CplMixVAE(device=DEV)
    server.load_model(path)
    reset_launch_counts()
    res, largest = largest_allocation(
        torch, lambda: server.eval_model(x[:n_serve], batch_size=B))
    served = launch_counts()
    n_launch = -(-n_serve // B)
    want = {**dict.fromkeys(served, 0), "coupling": n_launch,
            "recon_fwd": n_launch}
    print(f"  {tag} eval_model: {n_serve} cells, consensus "
          f"{res['consensus']:.6f}, total_loss {res['total_loss']:.6g}")
    check(served == want and server.cfg.n_arm == arms
          and np.asarray(res["pred_label"]).shape == (arms, n_serve)
          and math.isfinite(res["total_loss"])
          and bool(np.all(np.isfinite(res["c_prob"])))
          and largest < limit,
          f"{tag} serve: launches {served} (expect {want}), finite results, "
          f"largest allocation {largest / 1e6:.1f} MB (limit "
          f"{limit / 1e6:.0f} MB)")
    del trainer, server
    torch.cuda.empty_cache()
    return {"c8_training": trained, "c8_serving": served}


def phase_augmenter(torch, check, x_mse, x_zinb) -> None:
    """The frozen augmenter on the card against the port's CPU path, for
    both committed checkpoints, on 2,000 cells with the same explicit
    noise."""
    from dvae_tpu_torch.augment import augmenter as aug
    print("phase 7: the frozen augmenter, card vs the CPU path")
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    for name, path, x in (("MSE", AUG_MSE, x_mse), ("ZINB", AUG_ZINB, x_zinb)):
        params, bn, cfg = aug.load_augmenter(path, DEV)
        cparams, cbn, _ = aug.load_augmenter(path, "cpu")
        xb = x[:N_SMALL].contiguous()
        draws = aug.AugNoise(
            z=torch.randn((A, N_SMALL, cfg.noise_dim), generator=g),
            e=torch.randn((A, N_SMALL, cfg.latent_dim), generator=g))
        ddraws = aug.AugNoise(None, draws.z.to(DEV), draws.e.to(DEV))
        got = aug.augment_arms(params, bn, cfg, xb, A, 0.1, draws=ddraws)
        want = aug.augment_arms(cparams, cbn, cfg, xb.cpu(), A, 0.1,
                                draws=draws)
        torch.cuda.synchronize()
        err = rel_err(torch, got.cpu(), want)
        check(tuple(got.shape) == (A, N_SMALL, D)
              and bool(torch.isfinite(got).all()) and err <= 1e-4,
              f"augmenter_{name}: (n_zim {cfg.n_zim}) views {tuple(got.shape)} "
              f"finite, card vs CPU path max|diff|/max|view| {err:.2e} (tol "
              "1e-4: f32 products of depth 5032 and 1006 in another order)")
        _, full, _ = aug.apply_augmenter(params, bn, cfg,
                                         xb.expand(A, *xb.shape), scale=0.1,
                                         draws=ddraws)
        views = full[..., :D]
        if cfg.n_zim > 1:
            views = views * (xb > 0)
            zero = bool((got[:, xb == 0] == 0).all())
            check(zero and float((xb == 0).float().mean()) > 0.3,
                  f"augmenter_{name}: the views are zero wherever x is zero "
                  f"({float((xb == 0).float().mean()):.3f} of the entries)")
        e_b = rel_err(torch, got, views)
        check(e_b <= 1e-4 and not bool(torch.equal(got[0], got[1])),
              f"augmenter_{name}: augment_arms equals apply_augmenter on the "
              f"broadcast batch (rel err {e_b:.1e}, tol 1e-4: fc1..fc4 once "
              "on (B, D) against a batched product over A copies, summed in "
              "another order), and the arms' views differ")
        del params, bn, got, want, full, views
        torch.cuda.empty_cache()


def _drive_decoder_training(torch, check, tmp, x, tag, aug_file):
    """init_model(fused_decoder=True) -> train -> fresh load -> eval_model,
    counts set to 0 just before each run and read just after.  Returns
    (training counts, serving counts, checkpoint path)."""
    import numpy as np
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    folder = os.path.join(tmp, f"decoder_{tag}")
    trainer = CplMixVAE(saving_folder=folder, aug_file=aug_file, device=DEV,
                        seed=SEED)
    trainer.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                       lowD_dim=10, state_dim=2, batch_size=B,
                       epochs_per_jit=2, eval_every=2, ckpt_every=2,
                       fused_recon=True, fused_encoder=True,
                       fused_decoder=True)
    check(trainer.cfg.fused_decoder and trainer.cfg.fused_recon
          and trainer.cfg.fused_encoder
          and (trainer._augment_fn() is not None) == bool(aug_file),
          f"[{tag}] fused_decoder is taken, the default kernels stay on, "
          f"augmenter {'loaded' if aug_file else 'absent'}")
    x_train = x[:N_DEC_TRAIN]
    x_val = x[N_DEC_TRAIN:N_DEC_TRAIN + N_DEC_VAL]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    path = trainer.train(x_train, x_val=x_val, n_epoch=4,
                         early_stop_consensus=0, save_plots=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trained = launch_counts()
    rise = torch.cuda.max_memory_allocated() - base
    steps = 4 * (N_DEC_TRAIN // B)
    n_val = 2 * -(-N_DEC_VAL // B)
    print(f"  [{tag}] train: 4 epochs, {steps} steps, {N_DEC_TRAIN} cells, 2 "
          f"validations in {wall:.4f} s (cold, checkpoints included)")
    want = {**dict.fromkeys(trained, 0), "encoder_fwd": steps,
            "encoder_bwd": steps, "decoder_fwdbwd": steps,
            "decoder_fwd": n_val}
    check(trained == want, f"[{tag}] launches on the fused_decoder training "
                           f"path: {trained} (expect {want}: recon_fwd and "
                           "recon_fwdbwd never)")
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    print(f"  [{tag}] epoch losses: {losses}")
    check(len(losses) == 4 and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0],
          f"[{tag}] loss finite, last epoch's mean below the first's")
    val = [r for r in rows if "val/loss" in r]
    check(len(val) == 2 and all(math.isfinite(r["val/loss"]) for r in val),
          f"[{tag}] 2 validations with finite loss ({len(val)})")
    one = A * B * D * 4
    limit = 2 * one if aug_file else one
    check(rise < limit,
          f"[{tag}] peak allocated rise over the resident dataset "
          f"{rise / 1e6:.1f} MB (limit "
          + ("two (A,B,D) f32 tensors: the views and less than one more, "
             if aug_file else "one (A,B,D) f32 tensor, ")
          + f"{limit / 1e6:.0f} MB)")
    check(all(bool(torch.isfinite(v).all())
              for layer in trainer.state.params.values()
              for v in layer.values()), f"[{tag}] parameters finite")

    server = CplMixVAE(device=DEV, aug_file=aug_file)
    epoch = server.load_model(path)
    n_cells = N_DEC_TRAIN + N_DEC_VAL
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = server.eval_model(x[:n_cells], batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = launch_counts()
    rise = torch.cuda.max_memory_allocated() - base
    n_launch = -(-n_cells // B)
    print(f"  [{tag}] eval_model: {n_cells} cells in {wall:.4f} s = "
          f"{n_cells / wall:.1f} cells/s; consensus {res['consensus']:.6f}; "
          f"total_loss {res['total_loss']:.6g}; peak rise {rise / 1e6:.1f} MB")
    check(epoch == 4 and server.cfg.fused_decoder
          and served == {**dict.fromkeys(served, 0), "decoder_fwd": n_launch},
          f"[{tag}] a fresh instance takes fused_decoder from the checkpoint; "
          f"launches on the serving path: {served} (expect decoder_fwd "
          f"{n_launch}, recon_fwd 0)")
    check(rise < limit, f"[{tag}] serving peak rise {rise / 1e6:.1f} MB "
                        f"(limit {limit / 1e6:.0f} MB)")
    check(np.asarray(res["pred_label"]).shape == (A, n_cells)
          and math.isfinite(res["total_loss"])
          and bool(np.all(np.isfinite(res["c_prob"])))
          and bool(np.all(np.isfinite(res["total_loss_rec"])))
          and 0.0 <= res["consensus"] <= 1.0,
          f"[{tag}] labels of every cell, finite posteriors and losses, "
          "consensus in [0, 1]")
    serving_parity(check, server, path, x[:N_SMALL].cpu().numpy(),
                   x[:N_SMALL], aug_file)
    phase_parity_step(torch, check, path, x, aug_file)
    del trainer, server
    torch.cuda.empty_cache()
    return trained, served, path


def phase_decoder_path(torch, check, tmp, x) -> dict:
    """fused_decoder end to end at full width: with a shared batch and with
    the committed MSE augmenter's per-arm views, then once with use_pallas.
    Returns the launch counts of the five counted runs."""
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print("phase 8: fused_decoder end to end, without and with the augmenter")
    out = {}
    paths = {}
    for tag, aug_file in (("shared", None), ("augmented", AUG_MSE)):
        trained, served, paths[tag] = _drive_decoder_training(
            torch, check, tmp, x, tag, aug_file)
        out[f"decoder_{tag}_training"] = trained
        out[f"decoder_{tag}_serving"] = served
    x_train = x[:N_DEC_TRAIN]

    def loaded(path, aug_file=None, **flags):
        m = CplMixVAE(device=DEV, aug_file=aug_file)
        m.load_model(path)
        m.cfg = m.cfg.replace(**flags)
        return m

    # fused_decoder off and on from one checkpoint, in turns
    plain = loaded(paths["shared"], fused_decoder=False)
    fused = loaded(paths["shared"])
    ms = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        ms[which].append(warm_chunk_ms(
            torch, plain if which == "off" else fused, x_train, chunks=2))
    off, on = (sum(ms[k]) / 2 for k in ("off", "on"))
    print(f"  warm training step without fused_decoder {off:.3f} ms "
          f"({ms['off'][0]:.3f}, {ms['off'][1]:.3f}) = {B / off * 1e3:.1f} "
          f"cells/s; with fused_decoder {on:.3f} ms ({ms['on'][0]:.3f}, "
          f"{ms['on'][1]:.3f}) = {B / on * 1e3:.1f} cells/s")
    step_dev = {}
    for label, model in (("without fused_decoder", plain),
                         ("with fused_decoder", fused)):
        print(f"  profiled chunk {label}:")
        n_sync, kernels, busy = phase_chunk_breakdown(torch, model, x_train,
                                                      top=14)
        step_dev[label] = busy / 1e3 / (2 * (N_DEC_TRAIN // B))
        check(n_sync == 0, f"{n_sync} synchronising calls inside a chunk "
                           f"{label} (expect 0)")
        if busy:
            steps_prof = 2 * (N_DEC_TRAIN // B)
            groups = {"decoder_": 0.0, "recon_": 0.0, "encoder_": 0.0,
                      "gemm": 0.0}
            for t, _, name in kernels:
                for key in groups:
                    if key in name.lower():
                        groups[key] += t
                        break
            rest = busy - sum(groups.values())
            print("    per step: " + ", ".join(
                f"{k.strip('_')} {v / 1e3 / steps_prof:.3f} ms"
                for k, v in groups.items())
                + f", rest {rest / 1e3 / steps_prof:.3f} ms")
    if all(step_dev.values()):
        print("  training step on the device (profiler, one call): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in step_dev.items()))
    del plain, fused
    torch.cuda.empty_cache()

    # the augmented step, fused_decoder off and on, and the augmenter alone
    aug_off = loaded(paths["augmented"], AUG_MSE, fused_decoder=False)
    aug_on = loaded(paths["augmented"], AUG_MSE)
    ms = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        ms[which].append(warm_chunk_ms(
            torch, aug_off if which == "off" else aug_on, x_train, chunks=1))
    off, on = (sum(ms[k]) / 2 for k in ("off", "on"))
    print(f"  warm augmented training step without fused_decoder {off:.3f} ms "
          f"({ms['off'][0]:.3f}, {ms['off'][1]:.3f}) = {B / off * 1e3:.1f} "
          f"cells/s; with fused_decoder {on:.3f} ms ({ms['on'][0]:.3f}, "
          f"{ms['on'][1]:.3f}) = {B / on * 1e3:.1f} cells/s")
    fn = aug_on._augment_fn()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    xb = x[:B].contiguous()
    a_ms = cuda_ms(torch, lambda: fn(xb, A, gen), iters=10)
    macs = sum(k * n * (1 if i < 4 else A) for i, (k, n) in enumerate((
        (5032, 1006), (1006, 1006), (1006, 500), (500, 500), (50, 50),
        (550, 100), (100, 10), (100, 10), (10, 100), (100, 500), (500, 500),
        (500, 1006), (1006, 1006), (1006, 5032))))
    a_bound = 2.0 * B * macs / PEAK_FLOPS["float32"] * 1e3
    print(f"  the augmenter alone, {B} cells -> ({A}, {B}, {D}) views: "
          f"{a_ms:.4f} ms by events; {2.0 * B * macs / 1e9:.1f} GFLOP of f32 "
          f"products, {a_bound:.4f} ms at the FP32 peak (TF32 stays off)")
    print("  profiled augmented chunk with fused_decoder:")
    n_sync, _, _ = phase_chunk_breakdown(torch, aug_on, x_train, top=14)
    check(n_sync == 0, f"{n_sync} synchronising calls inside an augmented "
                       "chunk (expect 0): the views are made on the card")
    del aug_off, aug_on
    torch.cuda.empty_cache()

    # once with use_pallas: dz feeds the fused Gumbel backward
    ptrainer = CplMixVAE(saving_folder=os.path.join(tmp, "decoder_pallas"),
                         device=DEV, seed=SEED)
    ptrainer.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                        lowD_dim=10, state_dim=2, batch_size=B,
                        epochs_per_jit=2, use_pallas=True, fused_decoder=True)
    reset_launch_counts()
    ppath = ptrainer.train(x[:N_DEC_PALLAS], n_epoch=2,
                           early_stop_consensus=0, save_plots=False)
    torch.cuda.synchronize()
    pallas = launch_counts()
    psteps = 2 * (N_DEC_PALLAS // B)
    want = {**dict.fromkeys(pallas, 0), "encoder_fwd": psteps,
            "encoder_bwd": psteps, "decoder_fwdbwd": psteps,
            "gumbel_fwd": psteps, "gumbel_bwd": psteps, "coupling": psteps}
    check(pallas == want and not ptrainer._halted,
          f"launches of a fused_decoder run with use_pallas: {pallas} "
          f"(expect {want})")
    phase_parity_step(torch, check, ppath, x)
    del ptrainer
    torch.cuda.empty_cache()
    out["decoder_pallas_training"] = pallas
    return out


def streaming_dataset(torch, n: int, seed: int):
    """(n, D) f32 host tensor of planted programs (the synthetic generator's
    shape: sparse non-negative type centres plus Gaussian noise, ReLU),
    drawn on the card in blocks of 10,000 rows and copied to the host."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    centers = (torch.rand((C, D), generator=g, device=DEV) * 8.0
               * (torch.rand((C, D), generator=g, device=DEV) > 0.7))
    out = torch.empty((n, D), dtype=torch.float32)
    for lo in range(0, n, 10000):
        hi = min(n, lo + 10000)
        assign = torch.randint(0, C, (hi - lo,), generator=g, device=DEV)
        block = centers[assign] + 0.3 * torch.randn(
            (hi - lo, D), generator=g, device=DEV)
        out[lo:hi].copy_(block.clamp_min_(0.0))
    return out


def streamed_batches_exact(torch, check, x_host, x_csr) -> None:
    """10(a): the streamer's batches on the card, bit for bit the host
    gather of the same plan (dense f32, a bf16 cast on the host, a bf16
    host matrix, CSR densified), two epochs each."""
    from dvae_tpu_torch.data.stream import BatchStreamer
    x_bf = x_host.to(torch.bfloat16)
    cases = (("f32", x_host, None, x_host),
             ("f32 -> bf16 cast on the host", x_host, torch.bfloat16, x_bf),
             ("bf16 host matrix", x_bf, None, x_bf),
             ("CSR", x_csr, None, x_host))
    for name, src, dtype, ref in cases:
        bs = BatchStreamer(src, B, seed=SEED + 3, dtype=dtype, device=DEV,
                           prefetch=2)
        same, n = True, 0
        for e in (0, 1):
            plan = bs.plan(e)
            for i, b in enumerate(bs.epoch(e)):
                want = ref.index_select(0, torch.from_numpy(plan[i]))
                same &= (b.x.device.type == "cuda"
                         and b.x.dtype == want.dtype
                         and bool(torch.equal(b.x.cpu(), want)))
                n += 1
        check(same and n == 2 * bs.steps_per_epoch,
              f"10(a) {name}: {n} streamed batches ({B}, {D}) on the card "
              "bit for bit the host gather of the plan")


def manual_stream_loop(torch, cfg, tcfg, opt, x_host, epochs: int):
    """The streaming runner written out, on the card: the noise chain of
    chunk_rngs at epoch 0, the streamer's batches through make_train_step,
    one chunk of ``epochs`` epochs."""
    from dvae_tpu_torch.data.stream import BatchStreamer
    from dvae_tpu_torch.models.mixvae import Noise
    from dvae_tpu_torch.train.step import (chunk_rngs, init_train_state,
                                           make_train_step)
    state = init_train_state(SEED, cfg, opt, DEV)
    step = make_train_step(cfg, tcfg, opt)
    bs = BatchStreamer(x_host, tcfg.batch_size, seed=tcfg.seed, device=DEV,
                       dtype=torch.bfloat16 if tcfg.bf16 else None)
    gen, host = chunk_rngs(state.seed, state.epoch, DEV)
    for _ in range(epochs):
        for b in bs.epoch(state.epoch):
            enc_seed = int(host.integers(0, 2 ** 31 - 1))
            noise = (Noise(gumbel_seed=int(host.integers(0, 2 ** 31 - 1)))
                     if cfg.use_pallas else None)
            state, _, _ = step(state, b.x, b.prior, 1.0, generator=gen,
                               enc_seed=enc_seed, noise=noise)
        state = state._replace(epoch=state.epoch + 1)
    return state


def phase_streaming(torch, check, tmp, zinb_host) -> dict:
    """Phase 10: host→device streaming at the production width (A=5,
    D=5032, F=100, C=92, batch 5000).  (a) batches bit-equal to the host
    gather; (b) MSE training streamed from a dense host dataset of
    N_STREAM cells, 2 epochs and a validation: the loss falls, the
    counters match the steps, the peak device memory stays below half of
    the dataset's bytes; (c) a streamed chunk of 3 epochs bit for bit a
    manual step loop over the streamed batches; (d) the automatic switch,
    tripped by lowering the device fraction; (e) ZINB streamed from a CSR
    matrix of hard synthetic counts, validate and eval_model on CSR bit for
    bit the same calls on the dense array; (f) printed: streamed against
    resident warm ms/step in turns, the host gather, the pinned link rate,
    feed_census's predicted overlap against the measured one, host waits
    and synchronising calls per chunk.  Returns the launch counts of the
    counted runs."""
    import numpy as np
    import scipy.sparse as sp
    import dvae_tpu_torch.train.cpl_mixvae as tm
    from dvae_tpu_torch.data.stream import feed_census, make_streaming_runner
    from dvae_tpu_torch.train.step import (init_train_state,
                                           make_epoch_runner, tree_leaves)
    print("phase 10: host->device streaming")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    x_host = streaming_dataset(torch, N_STREAM + N_VAL, SEED + 10)
    x_train, x_val = x_host[:N_STREAM], x_host[N_STREAM:].numpy()
    nbytes = N_STREAM * D * 4
    small = x_host[:N_STREAM_SMALL]
    x_csr = sp.csr_matrix(small.numpy())
    print(f"  host dataset ({N_STREAM}, {D}) f32 = {nbytes / 1e9:.3f} GB, "
          f"{1 - x_csr.nnz / (N_STREAM_SMALL * D):.3f} zeros, made in "
          f"{time.perf_counter() - t0:.1f} s")
    streamed_batches_exact(torch, check, small, x_csr)
    out = {}

    # (b) MSE training streamed from the dense host dataset
    folder = os.path.join(tmp, "stream")
    trainer = tm.CplMixVAE(saving_folder=folder, device=DEV, seed=SEED)
    trainer.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                       lowD_dim=10, state_dim=2, batch_size=B,
                       epochs_per_jit=2, eval_every=2, ckpt_every=2,
                       stream=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train(x_train, x_val=x_val, n_epoch=2, early_stop_consensus=0,
                  save_plots=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = out["stream_training"] = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = 2 * (N_STREAM // B)
    want = {**dict.fromkeys(counts, 0), "encoder_fwd": steps,
            "encoder_bwd": steps, "recon_fwdbwd": steps, "recon_fwd": 1}
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    val = [r["val/loss"] for r in rows if "val/loss" in r]
    print(f"  10(b) train: {steps} streamed steps of {N_STREAM} cells in "
          f"{wall:.4f} s (cold, pinned ring and checkpoints included); epoch "
          f"losses {losses}; validation {val}")
    check(counts == want, f"10(b) launches of the streamed MSE run: {counts} "
                          f"(expect {want})")
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses + val)
          and losses[1] < losses[0] and len(val) == 1,
          "10(b) losses finite and falling, one finite validation")
    check(peak < nbytes / 2, f"10(b) peak device memory {peak / 1e6:.1f} MB "
          f"(base {base / 1e6:.1f} MB) below half of the dataset's "
          f"{nbytes / 1e6:.1f} MB")
    cfg, tcfg, opt = trainer.cfg, trainer.tcfg, trainer.tx
    del trainer

    # (c) one chunk of 3 epochs: the runner against the loop written out
    runner = make_streaming_runner(cfg, tcfg, opt, N_STREAM_SMALL,
                                   device=DEV)
    state, _ = runner(3)(init_train_state(SEED, cfg, opt, DEV), small, None,
                         1.0)
    manual = manual_stream_loop(torch, cfg, tcfg, opt, small, 3)
    same = all(bool(torch.equal(u, v)) for u, v in zip(
        tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
        + tree_leaves(state.opt_state.nu),
        tree_leaves(manual.params) + tree_leaves(manual.opt_state.mu)
        + tree_leaves(manual.opt_state.nu)))
    check(same and state.epoch == manual.epoch == 3
          and state.opt_state.count == 3 * (N_STREAM_SMALL // B),
          f"10(c) a streamed chunk of 3 epochs ({state.opt_state.count} "
          "steps): parameters and Adam moments bit for bit the manual step "
          "loop over the streamed batches")
    del state, manual

    # (d) the automatic switch, the device fraction lowered in-process
    fraction = tm._DEVICE_DATASET_FRACTION
    tm._DEVICE_DATASET_FRACTION = 1e-6
    try:
        auto = tm.CplMixVAE(device=DEV, seed=SEED)
        auto.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                        lowD_dim=10, state_dim=2, batch_size=B,
                        epochs_per_jit=2)
        off = auto.tcfg.stream
        reset_launch_counts()
        auto.train(small, n_epoch=2, early_stop_consensus=0,
                   save_plots=False)
        torch.cuda.synchronize()
        counts = out["stream_auto"] = launch_counts()
    finally:
        tm._DEVICE_DATASET_FRACTION = fraction
    steps = 2 * (N_STREAM_SMALL // B)
    check(not off and auto.tcfg.stream and auto.state.opt_state.count == steps
          and counts["encoder_fwd"] == counts["recon_fwdbwd"] == steps,
          f"10(d) the switch to streaming when the dataset exceeds the "
          f"lowered fraction: stream {off} -> {auto.tcfg.stream}, {steps} "
          f"steps, launches {counts}")
    del auto

    # (e) ZINB streamed from CSR; the CSR eval bit for bit the dense eval
    dense = zinb_host.numpy()
    csr = sp.csr_matrix(dense)
    n_tr = N_STREAM_ZINB
    z = tm.CplMixVAE(saving_folder=os.path.join(tmp, "stream_zinb"),
                     device=DEV, seed=SEED)
    z.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                 lowD_dim=10, state_dim=2, mode="ZINB", batch_size=B,
                 epochs_per_jit=2, eval_every=2, stream=True)
    reset_launch_counts()
    z.train(csr[:n_tr], x_val=csr[n_tr:], n_epoch=2, early_stop_consensus=0,
            save_plots=False)
    torch.cuda.synchronize()
    counts = out["stream_zinb"] = launch_counts()
    zsteps = 2 * (n_tr // B)
    n_val_batches = -(-(csr.shape[0] - n_tr) // B)
    want = {**dict.fromkeys(counts, 0), "encoder_fwd": zsteps,
            "encoder_bwd": zsteps, "zinb_fwdbwd": zsteps,
            "zinb_fwd": n_val_batches}
    check(counts == want and not z._halted,
          f"10(e) launches of ZINB streamed from CSR "
          f"({csr.nnz / csr.shape[0]:.0f} stored values a row): {counts} "
          f"(expect {want})")
    reset_launch_counts()
    v_csr = z.validate(csr[n_tr:], batch_size=B)
    v_dense = z.validate(dense[n_tr:], batch_size=B)
    r_csr = z.eval_model(csr, batch_size=B)
    r_dense = z.eval_model(dense, batch_size=B)
    served = out["stream_zinb_eval"] = launch_counts()
    same = all(np.array_equal(np.asarray(r_csr[k]), np.asarray(r_dense[k]))
               for k in r_dense)
    check(v_csr == v_dense and same and math.isfinite(v_csr["loss"]),
          f"10(e) validate and eval_model on CSR bit for bit the same calls "
          f"on the dense array (validation loss {v_csr['loss']:.6g}, "
          f"consensus {r_csr['consensus']:.6f}; zinb_fwd launches "
          f"{served['zinb_fwd']})")
    del z

    # (f) streamed against resident, in turns, and the feed's stages
    n = N_STREAM_TIMED
    xs, xd = x_host[:n], x_host[:n].to(DEV)
    state = init_train_state(SEED, cfg, opt, DEV)
    resident = make_epoch_runner(cfg, tcfg, opt, n, epochs_per_chunk=2)
    streamed_runner = make_streaming_runner(cfg, tcfg, opt, n, device=DEV,
                                            record_stats=True)
    streamed = streamed_runner(2)
    chunk_steps = 2 * (n // B)
    per_step = []  # host waits of each streamed step

    def timed(which):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "resident":
            state, ems = resident(state, xd, None, 1.0)
        else:
            st = streamed_runner.streamer
            before = len(st.stats.waits) if st is not None else 0
            state, ems = streamed(state, xs, None, 1.0)
        ems.total.cpu()
        ms = (time.perf_counter() - t0) / chunk_steps * 1e3
        if which == "streamed":
            per_step.extend(streamed_runner.streamer.stats.waits[before:])
        return ms

    timed("resident")
    timed("streamed")  # warm: the pinned ring is made here
    per_step.clear()
    ms = {"resident": [], "streamed": []}
    for which in ("resident", "streamed", "streamed", "resident"):
        ms[which].append(timed(which))
    res_ms, str_ms = (sum(v) / len(v) for v in (ms["resident"],
                                                 ms["streamed"]))
    print(f"  10(f) warm ms/step over {n} cells ({chunk_steps} steps a "
          f"chunk), in turns: resident {res_ms:.3f} ({ms['resident'][0]:.3f}"
          f", {ms['resident'][1]:.3f}), streamed {str_ms:.3f} "
          f"({ms['streamed'][0]:.3f}, {ms['streamed'][1]:.3f}); streamed / "
          f"resident {str_ms / res_ms:.3f}")
    # synchronising calls inside one streamed chunk
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, ems = streamed(state, xs, None, 1.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ems.total.cpu()
    n_sync = sum("called a synchronizing" in str(w.message) for w in caught)
    for w in caught[:3]:
        print(f"    {str(w.message)[:100]} ({os.path.basename(w.filename)}"
              f":{w.lineno})")
    check(n_sync == 0, f"10(f) {n_sync} synchronising calls inside a "
                       "streamed chunk (no value read back)")
    check(len(per_step) == 2 * chunk_steps and max(per_step) <= 1,
          f"10(f) host waits on an event: {sum(per_step)} over "
          f"{len(per_step)} steps of two streamed chunks, at most "
          f"{max(per_step)} a step (limit 1)")
    st = streamed_runner.streamer.stats
    gather = sorted(st.gather_s)[len(st.gather_s) // 2] * 1e3
    pinned = torch.empty((B, D), dtype=torch.float32, pin_memory=True)
    dst = torch.empty((B, D), dtype=torch.float32, device=DEV)
    h2d_ms = cuda_ms(torch, lambda: dst.copy_(pinned, non_blocking=True),
                     iters=10)
    gbps = B * D * 4 / h2d_ms / 1e6
    census = feed_census(xs, B, device=DEV, device_ms_per_step=res_ms,
                         link_gbps=gbps)
    measured = 100.0 * min(1.0, res_ms / str_ms)
    print(f"  10(f) host gather (f32, {B} rows) median {gather:.3f} ms in "
          f"the runner; H2D from pinned memory {h2d_ms:.3f} ms a batch = "
          f"{gbps:.2f} GB/s; feed_census {census}; predicted overlap "
          f"{census['predicted_overlap_pct']}% against measured "
          f"{measured:.1f}% (resident / streamed ms a step); host waits a "
          f"chunk {[sum(per_step[:chunk_steps]), sum(per_step[chunk_steps:])]}")
    del xd, state, resident, streamed, streamed_runner, pinned, dst
    torch.cuda.empty_cache()
    return out


def gan_noise(torch, g, a_cfg, rows: int, zinb: bool):
    """An explicit GanNoise of one step at ``rows`` cells, drawn on the card
    from ``g``: the two augmenter forwards' dropout masks and normals, the
    five discriminator keep-masks (P(keep) 0.8), the ZINB uniforms."""
    from dvae_tpu_torch.augment.augmenter import AugNoise
    from dvae_tpu_torch.augment.train import GanNoise
    D_ = a_cfg.input_dim

    def rand(*shape):
        return torch.rand(shape, generator=g, device=DEV)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=DEV)

    def aug():
        return AugNoise(rand(rows, D_) < 1 - a_cfg.p_drop,
                        normal(rows, a_cfg.noise_dim),
                        normal(rows, a_cfg.latent_dim))
    return GanNoise(aug(), aug(), tuple(rand(rows, D_) < 0.8
                                        for _ in range(3)),
                    tuple(rand(rows, D_) < 0.8 for _ in range(2)),
                    rand(rows, D_) if zinb else None,
                    rand(rows, D_) if zinb else None)


def _noise_on(noise, dev, dtype=None):
    """A GanNoise (or AugNoise, or tuple) with every tensor moved to dev,
    its floating ones in ``dtype`` when given (masks stay bool)."""
    if noise is None:
        return None
    if isinstance(noise, tuple):
        parts = [_noise_on(v, dev, dtype) for v in noise]
        return type(noise)(*parts) if hasattr(noise, "_fields") \
            else tuple(parts)
    return noise.to(dev, dtype if noise.is_floating_point() else None)


def gan_step_parity(torch, check, x_small) -> None:
    """11(a): one GAN step at full width (AugmenterConfig(), D=5032, n_dim
    500, noise 50, latent 10; DiscriminatorConfig(5032)) from the same state
    with the same explicit noise on the card, on the CPU path and in f64
    (the reference, on both), MSE and ZINB, f32 and bf16: losses, the gate,
    every gradient leaf against the card's f64, parameters after Adam."""
    import dvae_tpu_torch.augment.train as gt
    from dvae_tpu_torch.augment.augmenter import (AugmenterConfig,
                                                  DiscriminatorConfig)

    class RecordingAdam(gt.GatedAdam):
        """Keeps the gradients of its last update."""

        def update(self, grads, state, params, gate=None):
            self.grads = [g.detach().double().cpu() for g in grads]
            return super().update(grads, state, params, gate)

    def one(dev, x, nz, dtype, bf16):
        tx = RecordingAdam(LR), RecordingAdam(LR)
        state = gt.cast_gan_state(gt.init_gan_state(SEED, a_cfg, d_cfg, *tx,
                                                    dev), dtype)
        step = gt.make_gan_step(a_cfg, d_cfg, *tx, mode=mode, bf16=bf16)
        t0 = time.perf_counter()
        state, m = step(state, x.to(dtype), _noise_on(nz, dev, dtype))
        m = {k: float(v) for k, v in m._asdict().items()}
        return dict(state=state, m=m, s=time.perf_counter() - t0,
                    grads=tx[0].grads + tx[1].grads,
                    params=[t.detach().double().cpu() for t in
                            gt.tree_leaves(state.a_params)
                            + gt.tree_leaves(state.d_params)])

    def gap(u, v, share=False):
        """Per held leaf ‖u − v‖ / ‖v‖ (gradients), or the count beyond
        1e-5 (parameters); the biases that feed a batch norm left out."""
        out = []
        for nm, a, b in zip(names, u, v):
            if nm.endswith(".b") and nm.split(".")[1] in GAN_BN_FED:
                continue
            if share:
                out.append((int(((a - b).abs() > 1e-5).sum()), b.numel()))
            elif b.any():
                out.append(((a - b).norm().item() / b.norm().item(), nm))
        return (sum(f for f, _ in out) / sum(n for _, n in out) if share
                else sorted(out, reverse=True))

    def names_of(st):
        return [f"{t[0]}.{n}.{k}" for t in ("a_params", "d_params")
                for n in sorted(getattr(st, t))
                for k in sorted(getattr(st, t)[n])
                if getattr(st, t)[n][k] is not None]

    rows = x_small.shape[0]
    g = torch.Generator(device=DEV).manual_seed(SEED + 11)
    for mode in ("MSE", "ZINB"):
        a_cfg = AugmenterConfig(input_dim=D, n_zim=2 if mode == "ZINB"
                                else 1)
        d_cfg = DiscriminatorConfig(D)
        noise = gan_noise(torch, g, a_cfg, rows, mode == "ZINB")
        cpu_x, cpu_nz = x_small.cpu(), _noise_on(noise, "cpu")
        ref = one(DEV, x_small, noise, torch.float64, False)
        ref_cpu = one("cpu", cpu_x, cpu_nz, torch.float64, False)
        names = names_of(ref["state"])
        f64_err = max(((u - v).abs().max() / v.abs().max()).item()
                      for nm, u, v in zip(names, ref["grads"],
                                          ref_cpu["grads"])
                      if v.any() and not (nm.endswith(".b") and nm.split(
                          ".")[1] in GAN_BN_FED))
        loss_err = max(abs(ref["m"][k] - ref_cpu["m"][k])
                       / max(abs(ref_cpu["m"][k]), 1e-6) for k in ref["m"])
        check(f64_err <= TOL_GAN_F64 and loss_err <= TOL_GAN_F64,
              f"11(a) GAN step {mode} f64, card vs CPU path: every gradient "
              f"leaf (the biases that feed a batch norm left out) max "
              f"|diff| / max |CPU| {f64_err:.2e}, losses rel "
              f"{loss_err:.2e} (tol {TOL_GAN_F64:.0e}); card "
              f"{ref['s']:.2f} s, CPU {ref_cpu['s']:.2f} s")
        for bf16 in (False, True):
            name = f"{mode} {'bf16' if bf16 else 'f32'}"
            card = one(DEV, x_small, noise, torch.float32, bf16)
            cpu = one("cpu", cpu_x, cpu_nz, torch.float32, bf16)
            mg, mc = card["m"], cpu["m"]
            tol = TOL_GAN_LOSS[bf16]
            held = ("a_loss", "d_loss") if bf16 else tuple(mc)
            rels = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6)
                    for k in mc}
            check(all(rels[k] <= tol for k in held),
                  f"11(a) GAN step {name}, {rows} cells, card vs CPU path: "
                  + ", ".join(f"{k} {mg[k]:.6g}/{mc[k]:.6g}" for k in mc)
                  + f"; held {held} rel <= {tol:.0e} (worst "
                  f"{max(rels[k] for k in held):.2e}); card "
                  f"{card['s']:.2f} s, CPU {cpu['s']:.2f} s")
            check(mg["d_skipped"] == mc["d_skipped"] == ref["m"]["d_skipped"],
                  f"11(a) {name}: the gate's decision equal on both sides "
                  f"and in f64 (D step "
                  f"{'skipped' if mc['d_skipped'] else 'taken'})")
            errs, errs_cpu = (gap(r["grads"], ref["grads"])
                              for r in (card, cpu))
            tol = TOL_GAN_GRAD[bf16]
            check(errs[0][0] <= tol and (bf16 or errs_cpu[0][0] <= tol),
                  f"11(a) {name}: every gradient leaf against the card's "
                  f"f64, ‖diff‖ / ‖f64‖ <= {tol:g}; worst on the card "
                  + ", ".join(f"{nm} {e:.2e}" for e, nm in errs[:3])
                  + "; on the CPU path "
                  + ", ".join(f"{nm} {e:.2e}" for e, nm in errs_cpu[:3]))
            dmax = max((u - v).abs().max().item() for u, v in
                       zip(card["params"], cpu["params"]))
            share, share_cpu, share_pair = (
                gap(a["params"], b["params"], share=True)
                for a, b in ((card, ref), (cpu, ref), (card, cpu)))
            counts = (int(card["state"].d_opt.count),
                      int(cpu["state"].d_opt.count),
                      int(card["state"].a_opt.count))
            check(dmax <= 2 * LR and counts[0] == counts[1]
                  and counts[2] == 1
                  and (bf16 or share <= TOL_GAN_SHARE),
                  f"11(a) {name}: parameters after Adam, card vs CPU max "
                  f"|diff| {dmax:.2e} (tol 2*lr); beyond 1e-5 of the f64 "
                  f"step's, the biases that feed a batch norm left out: "
                  f"card {share:.3%}"
                  + ("" if bf16 else f" (tol {TOL_GAN_SHARE:.0%})")
                  + f", CPU path {share_cpu:.3%}; card vs CPU "
                  f"{share_pair:.3%}")
            del card, cpu
        del ref, ref_cpu

    # the trainer's rule where f32 rounding allows it: the CPU tests' widths
    for mode in ("MSE", "ZINB"):
        a_cfg = AugmenterConfig(input_dim=50, n_dim=20, noise_dim=10,
                                latent_dim=4,
                                n_zim=2 if mode == "ZINB" else 1)
        d_cfg = DiscriminatorConfig(50)
        x = x_small[:32, :50].contiguous()
        noise = gan_noise(torch, g, a_cfg, 32, mode == "ZINB")
        card = one(DEV, x, noise, torch.float32, False)
        cpu = one("cpu", x.cpu(), _noise_on(noise, "cpu"), torch.float32,
                  False)
        names = names_of(card["state"])
        share = gap(card["params"], cpu["params"], share=True)
        dmax = max((u - v).abs().max().item() for u, v in
                   zip(card["params"], cpu["params"]))
        check(dmax <= 2 * LR and share <= 1e-3,
              f"11(a) {mode} f32 at the CPU tests' widths (D 50, n_dim 20, "
              f"32 cells): parameters after Adam, card vs CPU max |diff| "
              f"{dmax:.2e} (tol 2*lr), {share:.3%} beyond 1e-5, the biases "
              "that feed a batch norm left out (tol 0.1%, the trainer's "
              "rule)")
    torch.cuda.empty_cache()


def gan_training(torch, check, tmp, x_train) -> str:
    """11(b): train_augmenter at production width (batch 5000, the 17,962
    training cells), MSE and ZINB in bf16, 3 epochs in one chunk each: finite
    metrics, mse_recon falling, the synchronising calls of the whole call
    (one host read per chunk, at the read, none inside), the D-skip share,
    the peak memory rise; ms a step in f32 and bf16 in turns by CUDA
    events.  Returns the path of the MSE augmenter it wrote."""
    import dvae_tpu_torch.augment.train as gt
    from dvae_tpu_torch.augment.augmenter import (AugmenterConfig,
                                                  DiscriminatorConfig,
                                                  save_augmenter)
    n = x_train.shape[0]
    steps = n // B
    path = os.path.join(tmp, "gan", "augmenter_MSE.ckpt")
    for mode in ("MSE", "ZINB"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                params, bn, cfg, hist = gt.train_augmenter(
                    x_train, n_epochs=GAN_EPOCHS, batch_size=B, mode=mode,
                    seed=546, bf16=True, epochs_per_jit=GAN_EPOCHS,
                    verbose=False, device=DEV)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        wall = time.perf_counter() - t0
        rise = (torch.cuda.max_memory_allocated() - base) / 1e6
        syncs = [(os.path.basename(w.filename), w.lineno) for w in caught
                 if "called a synchronizing" in str(w.message)]
        in_train = sorted({s for s in syncs if s[0] == "train.py"})
        n_train_syncs = sum(s[0] == "train.py" for s in syncs)
        mse = [h["mse_recon"] for h in hist]
        skipped = sum(h["d_skipped"] for h in hist) / len(hist)
        print(f"  11(b) train_augmenter {mode} bf16: {GAN_EPOCHS} epochs of "
              f"{steps} steps ({n} cells, batch {B}) in {wall:.3f} s cold; "
              f"mse_recon {[round(v, 5) for v in mse]}; a_loss "
              f"{[round(h['a_loss'], 4) for h in hist]}; D steps skipped "
              f"{skipped:.3f}; peak max_memory_allocated rise {rise:.1f} MB "
              f"(base {base / 1e6:.1f} MB); synchronising calls {len(syncs)}"
              f" ({sorted(set(syncs))})")
        check(all(math.isfinite(v) for h in hist for v in h.values())
              and len(hist) == GAN_EPOCHS and cfg.n_zim == (
                  2 if mode == "ZINB" else 1),
              f"11(b) {mode}: finite metrics for every epoch")
        check(mse[-1] < mse[0], f"11(b) {mode}: mse_recon falls "
                                f"({mse[0]:.5f} -> {mse[-1]:.5f})")
        check(n_train_syncs == 1 and len(in_train) == 1,
              f"11(b) {mode}: synchronising calls in the GAN loop: "
              f"{n_train_syncs} at {in_train} (expect one host read for "
              "the one chunk, 0 inside it; the others are the initial "
              "weights' copies to the card)")
        if mode == "MSE":
            save_augmenter(path, params, bn, cfg)
        del params, bn
    torch.cuda.empty_cache()

    # ms a step, f32 and bf16 in turns; the runner alone has no sync
    a_cfg, d_cfg = AugmenterConfig(input_dim=D), DiscriminatorConfig(D)
    runs = {}
    for bf16 in (False, True):
        tx = gt.GatedAdam(LR), gt.GatedAdam(LR)
        state = gt.init_gan_state(SEED, a_cfg, d_cfg, *tx, DEV)
        run = gt.make_gan_runner(gt.make_gan_step(a_cfg, d_cfg, *tx,
                                                  bf16=bf16), n, B)
        state, _ = run(state, x_train, 1)   # warm
        runs[bf16] = [run, state]
    ms = {False: [], True: []}
    for bf16 in (False, True, True, False):
        run, state = runs[bf16]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, m = run(state, x_train, 1)
        end.record()
        host = (time.perf_counter() - t0) / steps * 1e3
        torch.cuda.synchronize()
        runs[bf16][1] = state
        ms[bf16].append((start.elapsed_time(end) / steps, host))
    for bf16 in (False, True):
        ev = [round(v[0], 3) for v in ms[bf16]]
        print(f"  11(b) GAN step {'bf16' if bf16 else 'f32'} (MSE, batch "
              f"{B}): {sum(ev) / 2:.3f} ms a step by CUDA events {ev}; host "
              f"enqueue {[round(v[1], 3) for v in ms[bf16]]} ms a step")
    # where a bf16 step's device time goes, and the kernels it enqueues
    from torch.profiler import ProfilerActivity, profile
    run, state = runs[True]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = run(state, x_train, 1)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.self_device_time_total, e.count, e.key)
               for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(k[0] for k in kernels)
    if busy:
        gemm = sum(t for t, _, k in kernels
                   if "gemm" in k.lower() or "sm90" in k.lower())
        launches = sum(n for _, n, _ in kernels)
        print(f"  11(b) profiled bf16 GAN epoch: device busy "
              f"{busy / 1e3 / steps:.3f} ms a step (products "
              f"{gemm / 1e3 / steps:.3f}, the rest "
              f"{(busy - gemm) / 1e3 / steps:.3f}); {launches / steps:.0f} "
              f"kernel launches a step; the host's "
              f"{sum(v[1] for v in ms[True]) / 2:.3f} ms a step above")
        for t, n_, k in sorted(kernels, reverse=True)[:6]:
            print(f"    {t / 1e3 / steps:8.3f} ms/step {n_ // steps:4d}x  "
                  f"{k[:80]}")
    else:
        print("  11(b) profiler: no device time recorded (not measured)")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, m = run(state, x_train, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n_sync = sum("called a synchronizing" in str(w.message) for w in caught)
    check(n_sync == 0 and bool(torch.isfinite(m).all()),
          f"11(b) {n_sync} synchronising calls inside a GAN chunk of one "
          f"epoch ({steps} steps, bf16)")
    del runs, state
    torch.cuda.empty_cache()
    return path


def phase_gan(torch, check, tmp) -> dict:
    """Phase 11: the GAN that trains an augmenter and the hard-synthetic
    quality recipe at production width.  (a) one GAN step, card vs the CPU
    path; (b) train_augmenter's runs, syncs, ms a step, memory; (c) the
    augmenter it wrote through CplMixVAE(aug_file=...), 4 MSE steps with
    the augmented path's launches; (d) examples.hard_synthetic.run at its
    recipe (A=2, bf16, batch 5000, 20,000 cells of 5032 genes) for
    HS_EPOCHS epochs with that augmenter: its launches and numpy AMIs.
    Returns the launch counts of (c) and (d)."""
    from dvae_tpu_torch.data.pipeline import stratified_split_indices
    from dvae_tpu_torch.examples import hard_synthetic
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print("phase 11: GAN and quality recipe")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    ds = hard_synthetic._dataset(3, DEV)
    tr, te = stratified_split_indices(ds.cluster_label, 0.9, 3)
    print(f"  hard synthetic dataset {ds.log1p.shape} (data_seed 3), "
          f"{len(tr)} training cells, made in {time.perf_counter() - t0:.1f}"
          " s")
    x_train = torch.from_numpy(ds.log1p[tr]).to(DEV)
    gan_step_parity(torch, check, x_train[:N_SMALL].contiguous())
    path = gan_training(torch, check, tmp, x_train)
    out = {}

    # (c) the port-trained augmenter in the mixVAE trainer
    trainer = CplMixVAE(saving_folder=os.path.join(tmp, "gan_aug"),
                        aug_file=path, device=DEV, seed=SEED)
    trainer.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                       lowD_dim=10, state_dim=2, batch_size=B,
                       epochs_per_jit=2)
    reset_launch_counts()
    trainer.train(x_train[:2 * B], n_epoch=2, early_stop_consensus=0,
                  save_plots=False)
    torch.cuda.synchronize()
    counts = out["gan_augmented_training"] = launch_counts()
    want = {**dict.fromkeys(counts, 0), "encoder_fwd": 4, "encoder_bwd": 4,
            "recon_fwdbwd": 4}
    check(counts == want and not trainer._halted and math.isfinite(
        float(trainer.state.params["fc1"]["w"].sum())),
          f"11(c) the port-trained augmenter through CplMixVAE(aug_file=...)"
          f": 4 MSE steps, launches {counts} (expect {want})")
    del trainer, x_train
    torch.cuda.empty_cache()

    # (d) the quality recipe, short
    reset_launch_counts()
    t0 = time.perf_counter()
    res = hard_synthetic.run(n_epoch=HS_EPOCHS, aug_file=path, device=DEV,
                             folder=os.path.join(tmp, "hard_syn"),
                             verbose=False)
    torch.cuda.synchronize()
    counts = out["hard_synthetic"] = launch_counts()
    steps = HS_EPOCHS * (len(tr) // hard_synthetic.BATCH_SIZE)
    print(f"  11(d) examples.hard_synthetic.run(n_epoch={HS_EPOCHS}, "
          f"aug_file=<port-trained>) in {time.perf_counter() - t0:.1f} s: "
          f"leaf AMI {res['ami_leaf']}, root AMI {res['ami_root']}, arm-arm "
          f"{res['ami_arm_arm']:.4f}, test consensus "
          f"{res['test_consensus']:.4f}, scored at epoch "
          f"{res['final_epoch']}; launches {counts}")
    amis = res["ami_leaf"] + res["ami_root"] + [res["ami_arm_arm"]]
    check(counts["encoder_fwd"] == counts["encoder_bwd"]
          == counts["recon_fwdbwd"] == steps and counts["recon_fwd"] >= 1
          and all(math.isfinite(v) and -1.0 <= v <= 1.0 for v in amis),
          f"11(d) the recipe through the counted kernels ({steps} steps: "
          f"encoder_fwd/bwd and recon_fwdbwd each {steps}, recon_fwd "
          f"{counts['recon_fwd']} in its scoring) and finite AMIs")
    print(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 12, the analysis and interop path: generate over three batches
# (the last padded), the traversal, cross-run consensus over 22,000 cells
N_GEN, N_EVALS2, TRAV_SAMP = 12000, 22000, 8
# generate's peak memory rise, in (A, B, D) f32 tensors: the plain MSE loss
# holds at once x_rec, binarize(x_rec), t·log p, (1 − t) expanded, 1 − p and
# _safe_log's bool mask, clamp, log and fill (models/losses.bce), 8.25 of
# them, beside the (B, D) batch and its binarized copy (0.2 each): below 9
GEN_PEAK_ABD = 9


def _eval_noise(torch, seed: int, rows: int, pad_to: int):
    """The reparameterisation draw eval_model makes for a batch of ``rows``
    cells (a CPU generator seeded with the state's seed), zero-padded to
    ``pad_to`` rows for generate's padded batch."""
    e = torch.zeros((A, pad_to, 2))
    e[:, :rows] = torch.randn((A, rows, 2),
                              generator=torch.Generator().manual_seed(seed))
    return e


def _reference_pth(torch, path: str, zinb: bool, pruned: bool, adam: bool,
                   seed: int) -> None:
    """A reference MMIDAS trainer checkpoint at the production width, made
    with torch alone from a seed: per-arm ModuleList names, nn.Linear's
    default init, random running statistics, a pruned fcc (its last two
    categories masked) and Adam moments in parameters() order on request.
    Written to ``path``; returns nothing."""
    g = torch.Generator().manual_seed(seed)
    S, L = 2, 10
    dims = {"fc1": (F, D), "fc2": (F, F), "fc3": (F, F), "fc4": (F, F),
            "fc5": (L, F), "fcc": (C, L), "fc_mu": (S, L + C),
            "fc_sigma": (S, L + C), "fc6": (L, C + S), "fc7": (F, L),
            "fc8": (F, F), "fc9": (F, F), "fc10": (F, F), "fc11": (D, F)}
    if zinb:
        dims["fc11_p"] = dims["fc11_r"] = (D, F)
    sd = {}
    for name, (o, i) in dims.items():
        for a in range(A):
            bound = 1.0 / i ** 0.5
            w = (2 * torch.rand((o, i), generator=g) - 1) * bound
            if pruned and name == "fcc":
                mask = torch.ones(o, i)
                mask[-2:] = 0.0
                sd[f"{name}.{a}.weight_orig"] = w
                sd[f"{name}.{a}.weight_mask"] = mask
            else:
                sd[f"{name}.{a}.weight"] = w
            sd[f"{name}.{a}.bias"] = (2 * torch.rand(o, generator=g) - 1) \
                * bound
    for i, d in zip(range(1, 6), (F, F, F, F, L)):
        for a in range(A):
            sd[f"batch_l{i}.{a}.running_mean"] = 0.1 * torch.randn(
                d, generator=g)
            sd[f"batch_l{i}.{a}.running_var"] = 0.5 + torch.rand(
                d, generator=g)
            sd[f"batch_l{i}.{a}.num_batches_tracked"] = torch.tensor(7)
    ckpt = {"model_state_dict": sd}
    if adam:
        keys = [k for k in sd if not k.startswith("batch_")]
        ckpt["optimizer_state_dict"] = {
            "state": {j: {"step": torch.tensor(11.0),
                          "exp_avg": 1e-3 * torch.randn(sd[k].shape,
                                                        generator=g),
                          "exp_avg_sq": 1e-6 * torch.rand(sd[k].shape,
                                                          generator=g)}
                      for j, k in enumerate(keys)},
            "param_groups": [{"lr": 2e-3, "params": list(range(len(keys)))}]}
    torch.save(ckpt, path)


def _import_checks(torch, check, ckpt: dict, out: str, what: str) -> None:
    """The imported checkpoint against the reference dict it came from: the
    parameters its transposed tensors bit for bit (a pruned weight as
    weight_orig · weight_mask), the statistics, the category mask and the
    Adam moments bit for bit."""
    import numpy as np
    from dvae_tpu_torch.utils.checkpoint import (adam_state_from_jax,
                                                 load_checkpoint)
    tree, meta = load_checkpoint(out)
    sd = ckpt["model_state_dict"]
    same = True
    for name, layer in tree["params"].items():
        for a in range(A):
            if f"{name}.{a}.weight" in sd:
                w = sd[f"{name}.{a}.weight"]
            else:
                w = sd[f"{name}.{a}.weight_orig"] * sd[f"{name}.{a}.weight_mask"]
            same &= layer["w"][a].tobytes() == w.numpy().T.tobytes()
            same &= layer["b"][a].tobytes() == sd[f"{name}.{a}.bias"] \
                .numpy().tobytes()
    for i in range(1, 6):
        for a in range(A):
            for ours, ref in (("mean", "running_mean"), ("var", "running_var")):
                same &= (tree["bn"][f"bn{i}"][ours][a].tobytes()
                         == sd[f"batch_l{i}.{a}.{ref}"].numpy().tobytes())
    check(same, f"{what}: parameters and statistics are the state dict's "
                "(transposed) tensors bit for bit")
    pruned = "fcc.0.weight_mask" in sd
    want_mask = np.ones(C, np.float32)
    if pruned:
        want_mask[-2:] = 0.0
    check(np.array_equal(tree["mask"], want_mask)
          and (not pruned or not np.any(tree["params"]["fcc"]["w"][:, :, -2:])),
          f"{what}: category mask {int(tree['mask'].sum())} of {C}"
          + (", the pruning mask folded into fcc" if pruned else ""))
    opt = ckpt.get("optimizer_state_dict")
    count, mu, nu = adam_state_from_jax(tree["opt_state"])
    if opt and not pruned:
        keys = [k for k in sd if not k.startswith("batch_")]
        ok = meta["moments_imported"] and count == 11
        for j, k in enumerate(keys):
            name, a, kind = k.split(".")
            leaf = "w" if kind == "weight" else "b"
            m, v = (opt["state"][j][s].numpy() for s in ("exp_avg",
                                                          "exp_avg_sq"))
            if leaf == "w":
                m, v = m.T, v.T
            ok &= mu[name][leaf][int(a)].tobytes() == m.tobytes()
            ok &= nu[name][leaf][int(a)].tobytes() == v.tobytes()
        check(ok, f"{what}: Adam count 11 and both moments bit for bit in "
                  "the checkpoint's key order")
    else:
        check(count == 0 and not meta["moments_imported"],
              f"{what}: a fresh optimizer state (count {count})")


def phase_analysis(torch, check, tmp, x_host, mse_ckpt, pallas_ckpt):
    """The analysis and interop path at full width: generate, the traversal
    study, cross-run consensus and import-torch.  Returns the launch counts
    of its counted runs and generate's (x_low, pred_label) of arm 0."""
    import numpy as np
    from dvae_tpu_torch.eval.evaluate import evals2, evals2_files
    from dvae_tpu_torch.examples.state_traversal import traversal_study
    from dvae_tpu_torch.models import mixvae
    from dvae_tpu_torch.models.api import generate, load_vae
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print("phase 12: the analysis and interop path")
    t_phase = time.perf_counter()
    counts = {}

    # (a) load_vae -> generate over 12,000 cells, the last batch padded
    cfg, params, bn, mask = load_vae(pallas_ckpt, device=DEV)
    cpu_model = load_vae(pallas_ckpt, device="cpu")
    check(cfg.use_pallas, "load_vae takes use_pallas from the checkpoint")
    server = CplMixVAE(device=DEV)
    server.load_model(pallas_ckpt)
    seed = server.state.seed
    sizes = [min(B, N_GEN - i) for i in range(0, N_GEN, B)]
    noise = [_eval_noise(torch, seed, n, B) for n in sizes]
    xg = x_host[:N_GEN]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    gen = generate(cfg, params, bn, xg, mask=mask, batch_size=B, noise=noise)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["analysis_generate"] = launched = launch_counts()
    rise = torch.cuda.max_memory_allocated() - base
    unit = A * B * D * 4
    print(f"  generate: {N_GEN} cells in {wall:.4f} s ({len(sizes)} batches, "
          f"the last of {sizes[-1]} padded to {B}); peak allocated rise "
          f"{rise / 1e6:.1f} MB = {rise / unit:.3f} (A,B,D) f32 tensors")
    check(launched == {**dict.fromkeys(launched, 0),
                       "coupling": len(sizes)},
          f"launches of generate: {launched} (expect coupling "
          f"{len(sizes)}, one a batch, and no other kernel)")
    check(rise < GEN_PEAK_ABD * unit,
          f"generate's peak rise below {GEN_PEAK_ABD} (A,B,D) f32 tensors "
          f"({GEN_PEAK_ABD * unit / 1e6:.0f} MB)")
    shapes = {"recon": (A, N_GEN, D), "c_prob": (A, N_GEN, C),
              "c_smp": (A, N_GEN, C), "state": (A, N_GEN, 2),
              "state_mu": (A, N_GEN, 2), "state_logvar": (A, N_GEN, 2),
              "x_low": (A, N_GEN, 10), "pred_label": (A, N_GEN),
              "loss_rec": (A,)}
    check(all(gen[k].shape == v and bool(np.isfinite(gen[k]).all())
              for k, v in shapes.items()),
          "generate's outputs: JAX's keys and shapes, finite")
    served = server.eval_model(xg, batch_size=B)
    _served_within_limits(check, gen, served,
                          "generate vs eval_model on the card")
    # the card against the CPU path on the first 2,000 cells, same noise
    small_noise = [noise[0][:, :N_SMALL]]
    want = generate(*cpu_model[:3], xg[:N_SMALL], mask=cpu_model[3],
                    batch_size=N_SMALL, noise=small_noise)
    got = generate(cfg, params, bn, xg[:N_SMALL], mask=mask,
                   batch_size=N_SMALL, noise=small_noise)
    _served_within_limits(check, got, want,
                          f"generate on {N_SMALL} cells, card vs CPU")
    head = {k: v[:, :N_SMALL] for k, v in gen.items() if k != "loss_rec"}
    _served_within_limits(check, head, want,
                          f"the {N_GEN}-cell run's first {N_SMALL} cells vs "
                          "the CPU")
    # phase 13 scores arm 0's latent space and labels
    latent = (gen["x_low"][0].copy(), gen["pred_label"][0].copy())
    del gen, served, head

    # (b) state_changes and the traversal study
    g = torch.Generator().manual_seed(SEED + 12)
    e = torch.randn((A, N_SMALL, 2), generator=g)
    draws = torch.randn((TRAV_SAMP, A, N_SMALL), generator=g)
    xs = torch.as_tensor(xg[:N_SMALL])
    t0 = time.perf_counter()
    recon, s_vals = mixvae.state_changes(params, bn, cfg, xs.to(DEV), d_s=0,
                                         n_samp=TRAV_SAMP, noise=e,
                                         draws=draws)
    torch.cuda.synchronize()
    print(f"  state_changes: {tuple(recon.shape)} "
          f"({recon.numel() * 4 / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.4f} s")
    r_cpu, s_cpu = mixvae.state_changes(cpu_model[1], cpu_model[2], cfg, xs,
                                        d_s=0, n_samp=TRAV_SAMP, noise=e,
                                        draws=draws)
    dr = rel_err(torch, recon.cpu(), r_cpu)
    ds = rel_err(torch, s_vals.cpu(), s_cpu)
    check(dr <= 1e-4 and ds <= 1e-4,
          f"state_changes card vs CPU: recon {dr:.2e}, values {ds:.2e} of "
          "their largest entries (tol 1e-4)")
    check(bool((s_vals[:, 1:] >= s_vals[:, :-1]).all()),
          "the values ascend along the sample axis")
    del recon, s_vals, r_cpu, s_cpu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    study = traversal_study(cfg, params, bn, xg[:N_SMALL], d_s=0,
                            n_samp=TRAV_SAMP)
    corr = study["gene_corr_sorted"]
    print(f"  traversal_study on {N_SMALL} cells, {TRAV_SAMP} samples: "
          f"{time.perf_counter() - t0:.3f} s; top genes "
          f"{study['gene_order'][-5:][::-1].tolist()}, max |r| "
          f"{corr[-1]:.4f}")
    check(corr.shape == (D,) and bool(np.isfinite(corr).all())
          and bool((np.diff(corr) >= 0).all()),
          "the traversal's sorted correlations are finite and ascending")
    del study, server, params, bn, cpu_model
    torch.cuda.empty_cache()

    # (c) evals2_files on the MSE and use_pallas checkpoints
    xe = x_host[:N_EVALS2]
    reset_launch_counts()
    t0 = time.perf_counter()
    e2 = evals2_files(mse_ckpt, pallas_ckpt, xe, batch_size=B, device=DEV)
    torch.cuda.synchronize()
    counts["analysis_evals2"] = launched = launch_counts()
    n_b = -(-N_EVALS2 // B)
    print(f"  evals2_files over {N_EVALS2} cells in "
          f"{time.perf_counter() - t0:.3f} s; mean between-run consensus "
          f"{float(e2['between'].mean()):.4f}")
    check(launched == {**dict.fromkeys(launched, 0), "recon_fwd": 2 * n_b,
                       "coupling": n_b},
          f"launches of evals2_files: {launched} (expect eval_model's: "
          f"recon_fwd {2 * n_b}, coupling {n_b})")
    mats = [e2[k] for k in ("within_a", "within_b", "between", "l2_between")]
    check(all(np.array_equal(np.diag(e2[k]), np.ones(A))
              for k in ("within_a", "within_b"))
          and all(bool(((m >= 0) & (m <= 1)).all()) for m in mats[:3])
          and bool(np.isfinite(mats[3]).all()),
          "within-run diagonals 1, every consensus in [0, 1], L2 finite")
    labels = []
    for f in (mse_ckpt, pallas_ckpt):
        cpl = CplMixVAE(device=DEV)
        cpl.load_model(f)
        labels.append(cpl.eval_model(xe, batch_size=B)["pred_label"])
    again = evals2(*labels, K=C)
    check(all(np.array_equal(e2[k], again[k])
              for k in ("within_a", "within_b", "between")),
          "within_a, within_b and between equal evals2 of the two "
          "eval_model label sets exactly")
    del e2, labels, cpl

    # (d) import-torch of reference .pth files at the production width: the
    # three commands run at once (each a fresh interpreter).  The ZINB model
    # serves count data (the hard synthetic generator's): the synthetic
    # MSE data reach log1p 30, counts past the ZINB kernels' clamp of 1e12
    # (ops/zinb.py, as zinb_pallas.py), where the CPU path, unfused for a
    # checkpoint without fused_recon, takes torch.lgamma of the raw count
    from dvae_tpu_torch.data.anndata_io import hard_synthetic_dataset
    x_counts = hard_synthetic_dataset(n_cells=N_SMALL, n_genes=D, n_types=C,
                                      seed=SEED, device=DEV).log1p
    cases = (("mse_adam", False, False, True, "auto"),
             ("mse_pruned", False, True, False, "model"),
             ("zinb_adam", True, False, True, "auto"))
    jobs = []
    for tag, zinb, pruned, adam, kind in cases:
        pth = os.path.join(tmp, f"cpl_mixVAE_model_epoch_40_{tag}.pth")
        _reference_pth(torch, pth, zinb, pruned, adam, seed=SEED + len(tag))
        out = os.path.join(tmp, f"imported_{tag}.ckpt")
        jobs.append((pth, out, subprocess.Popen(
            [sys.executable, "-m", "dvae_tpu_torch.cli", "import-torch", pth,
             "--kind", kind, "--out", out], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=_HERE)))
    t0 = time.perf_counter()
    for (tag, zinb, _, _, kind), (pth, out, proc) in zip(cases, jobs):
        stdout, stderr = proc.communicate(timeout=300)
        check(proc.returncode == 0 and os.path.exists(out),
              f"cli import-torch --kind {kind} {tag}: rc {proc.returncode} "
              f"({time.perf_counter() - t0:.2f} s for the three so far) "
              f"{stdout.strip().splitlines()[-1:]}{stderr[-300:]}")
        _import_checks(torch, check, torch.load(pth, weights_only=False),
                       out, tag)
        srv = CplMixVAE(device=DEV)
        srv.load_model(out)
        check(srv.cfg.mode == ("ZINB" if zinb else "MSE")
              and srv.cfg.fused_recon
              and all(v.is_contiguous() for layer in srv.state.params.values()
                      for v in layer.values()),
              f"{tag}: served in {srv.cfg.mode} mode through the kernels, "
              "every parameter contiguous (fault C10)")
        xi = x_counts if zinb else x_host[:N_SMALL]
        reset_launch_counts()
        srv.eval_model(xi, batch_size=B)
        torch.cuda.synchronize()
        counts[f"analysis_import_{tag}"] = launched = launch_counts()
        kernel = "zinb_fwd" if zinb else "recon_fwd"
        check(launched == {**dict.fromkeys(launched, 0), kernel: 1},
              f"{tag}: launches serving {N_SMALL} cells {launched} (expect "
              f"{kernel} 1)")
        serving_parity(check, srv, out, xi, torch.as_tensor(xi).to(DEV))
        del srv
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
    return counts, latent


# phase 13, the taxonomy and clusterability path: the taxonomy study at the
# production width on a planted taxonomy of 64 leaves (96 categories), cut
# to 4 epochs (its own default is 4000), in one chunk; clusterability on
# phase 12's generate output
TAX_DEPTH, TAX_CELLS, TAX_EPOCHS = 6, 20000, 4
TAX_ROOT = "n1"
CLUS_KFOLD, CLUS_PC = 3, 5
# the silhouette on the card against the same call on the CPU: f64 sums of
# the same direct distances in another order
TOL_SILH = 1e-10
# the PCA transform's silhouettes, card against CPU: one f64 SVD each
TOL_PCA_SILH = 1e-8


def write_dend_csv(tree, path: str) -> None:
    """``tree`` as a dend CSV in the Allen schema (x, y, leaf, label,
    parent, col), written with the csv module the way R exports it: TRUE
    and FALSE, NA for the root's parent."""
    import csv
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["x", "y", "leaf", "label", "parent", "col"])
        for i in range(len(tree.child)):
            w.writerow([repr(float(tree.x[i])), repr(float(tree.y[i])),
                        "TRUE" if tree.isleaf[i] else "FALSE",
                        tree.child[i],
                        "NA" if tree.parent[i] == "root" else tree.parent[i],
                        tree.col[i]])


def same_tree(a, b) -> bool:
    import numpy as np
    return (all(getattr(a, k).tolist() == getattr(b, k).tolist()
                for k in ("child", "parent", "col", "isleaf"))
            and all(np.array_equal(getattr(a, k), getattr(b, k),
                                   equal_nan=True) for k in ("x", "y")))


def phase_taxonomy(torch, check, tmp, latent) -> dict:
    """The taxonomy and clusterability path at full width: the taxonomy
    study (training through the kernels, the merge sweep), merged types
    from a dend CSV at every level, and the clusterability scores of
    phase 12's generate output.  Returns the launch counts of its counted
    runs."""
    import numpy as np
    from dvae_tpu_torch.analysis import tree_based
    from dvae_tpu_torch.config import TrainConfig
    from dvae_tpu_torch.data.pipeline import stratified_split_indices
    from dvae_tpu_torch.eval import cluster_analysis as ca
    from dvae_tpu_torch.examples import taxonomy_study
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print("phase 13: the taxonomy and clusterability path")
    t_phase = time.perf_counter()
    card = card_line()
    counts = {}
    study_seed = 546   # taxonomy_study.run's default

    # (a) the study through its entry point; the arguments of its merge
    # sweep are kept for the checks that follow
    seen = {}
    sweep = taxonomy_study.merge_sweep

    def spy(tree, truth, pred):
        seen.update(tree=tree, truth=truth, pred=pred)
        return sweep(tree, truth, pred)

    folder = os.path.join(tmp, "taxonomy")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    taxonomy_study.merge_sweep = spy
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = taxonomy_study.run(
            depth=TAX_DEPTH, n_cells=TAX_CELLS, n_genes=D, n_arm=A,
            batch_size=B, n_epoch=TAX_EPOCHS, epochs_per_jit=TAX_EPOCHS,
            folder=folder, save_plots=False, verbose=False, device=DEV)
    finally:
        taxonomy_study.merge_sweep = sweep
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["taxonomy_study"] = launched = launch_counts()
    rise = torch.cuda.max_memory_allocated() - base
    n_leaves, n_test = 2 ** TAX_DEPTH, len(seen["truth"])
    steps = TAX_EPOCHS * ((TAX_CELLS - n_test) // B)
    # one chunk of TAX_EPOCHS epochs: a validation when it crosses
    # eval_every; each eval pass one recon_fwd a batch
    n_val = int(TAX_EPOCHS >= TrainConfig().eval_every)
    eval_batches = -(-n_test // B)
    want = {**dict.fromkeys(launched, 0), "encoder_fwd": steps,
            "encoder_bwd": steps, "recon_fwdbwd": steps,
            "recon_fwd": (n_val + 1) * eval_batches}
    check(launched == want,
          f"launches of the taxonomy study: {launched} (expect {steps} "
          f"training steps of encoder_fwd, encoder_bwd, recon_fwdbwd; "
          f"recon_fwd {(n_val + 1) * eval_batches}: {n_val} validations and "
          f"the label pass over {n_test} cells; every other 0)")
    with open(os.path.join(folder, "metrics.jsonl")) as f:
        epoch_s = [json.loads(line)["train/epoch_time_s"] for line in f
                   if "train/epoch_time_s" in line]
    ms_step = 1e3 * epoch_s[-1] * TAX_EPOCHS / steps if epoch_s else math.nan
    levels = out["levels"]
    print(f"  taxonomy study: {TAX_CELLS} cells x {D} genes, {n_leaves} "
          f"leaves, {out['n_categories']} categories, A={A}, {steps} steps "
          f"in {wall:.2f} s (with the data's generation and the sweep); "
          f"training {ms_step:.3f} ms/step (the trainer's first chunk, host "
          f"clock); peak allocated rise {rise / 1e6:.1f} MB; leaf AMI "
          f"{[round(a, 4) for a in out['leaf_ami']]}; {len(levels)} levels, "
          f"best {out['best_level']['n_classes']} classes; {card}")
    check(out["n_leaves"] == n_leaves
          and out["n_categories"] == int(1.5 * n_leaves),
          f"the study's tree: {n_leaves} leaves, {int(1.5 * n_leaves)} "
          "categories")
    check(len(out["leaf_ami"]) == A
          and bool(np.isfinite(out["leaf_ami"]).all())
          and len(levels) == n_leaves - 1
          and all(len(r["ami"]) == A and np.isfinite(r["ami"]).all()
                  for r in levels),
          f"leaf AMI and every one of the {len(levels)} levels' AMIs "
          "finite, one a arm")
    again = taxonomy_study.merge_sweep(seen["tree"], seen["truth"],
                                       seen["pred"])
    check(again == levels,
          "merge_sweep run again on the card's labels (a host function) "
          "equals the study's levels exactly")
    # the card's labels against the CPU path's, from the checkpoint the
    # study served (the same data and split, remade on the host)
    _, X, labels = taxonomy_study.hierarchical_synthetic(
        TAX_DEPTH, TAX_CELLS, D, study_seed)
    _, te = stratified_split_indices(labels, 0.9, study_seed)
    check(labels[te].tolist() == seen["truth"].tolist(),
          "the remade test split is the study's")
    cpu = CplMixVAE(device="cpu")
    cpu.load_model(os.path.join(folder, "cpl_mixVAE_model_best_train.ckpt"))
    cpu_pred = cpu._predict_labels(X[te], 1.0)
    agree = (cpu_pred == seen["pred"]).mean(axis=1)
    cpu_levels = taxonomy_study.merge_sweep(seen["tree"], seen["truth"],
                                            cpu_pred)
    gap = max(abs(a - b) for r, c in zip(levels, cpu_levels)
              for a, b in zip(r["ami"], c["ami"]))
    print(f"  the card's test labels against the CPU path's: agreement by "
          f"arm {agree.round(5).tolist()}; largest AMI gap over the levels "
          f"{gap:.2e}; {card}")
    check(bool((agree >= 0.999).all())
          and [r["n_classes"] for r in cpu_levels]
          == [r["n_classes"] for r in levels] and gap <= 1e-2,
          "labels card vs CPU ≥ 0.999 agree (the serving limit); the "
          "sweep's AMIs within 1e-2")
    del X, labels, cpu

    # (b) the taxonomy without pandas: merged types from a dend CSV equal
    # the tree in memory at every level
    tree, truth = seen["tree"], seen["truth"]
    dend = os.path.join(tmp, "taxonomy_dend.csv")
    write_dend_csv(tree, dend)
    t0 = time.perf_counter()
    bad = []
    for k in range(2, n_leaves + 1):
        got = tree_based.get_merged_types(dend, truth, num_classes=k,
                                          node=TAX_ROOT)
        mem = tree.get_merged_types(truth, num_classes=k, node=TAX_ROOT)
        if not (got[0].tolist() == mem[0].tolist()
                and same_tree(got[1], mem[1])
                and same_tree(got[2], mem[2])):
            bad.append(k)
    print(f"  get_merged_types from the dend CSV at {n_leaves - 1} levels: "
          f"{time.perf_counter() - t0:.2f} s on the host; {card}")
    check(not bad, f"get_merged_types(csv) equals the tree in memory for "
                   f"every k in 2..{n_leaves}: labels and mod_subtree's "
                   f"columns (differing at {bad})")
    check("pandas" not in sys.modules,
          "the taxonomy path ran without loading pandas")

    # (c) clusterability of phase 12's generate output (x_low of arm 0)
    x_low, found, ref = latent
    label_sets = {"discovered": found, "reference": ref}
    reset_launch_counts()
    xd = torch.as_tensor(x_low).to(DEV)
    t0 = time.perf_counter()
    for kind in ("lda", "qda"):
        acc, _, pred = ca.kfold_classifier(x_low, label_sets,
                                           kfold=CLUS_KFOLD, kind=kind)
        print(f"  {kind} {CLUS_KFOLD}-fold accuracy on {x_low.shape}: "
              + ", ".join(f"{k} {np.mean(v):.4f}" for k, v in acc.items())
              + f"; {card}")
        check(all(len(v) == CLUS_KFOLD and all(0.0 <= a <= 1.0 for a in v)
                  for v in acc.values())
              and sum(len(p) for p in pred["reference"]) == len(ref),
              f"{kind}: {CLUS_KFOLD} accuracies in [0, 1] a label set, "
              "every cell predicted once")
    lda_s = time.perf_counter() - t0
    smp_card = ca.silhouette_samples(xd, found)  # warm-up and the values
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per, overall = ca.get_SilhScore(xd, found)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_cpu, overall_cpu = ca.get_SilhScore(x_low, found, device="cpu")
    cpu_s = time.perf_counter() - t0
    host = ca.silhouette_samples(x_low, found, device="cpu")
    d_smp = float(np.abs(smp_card - host).max())
    d_per = float(np.abs(per - per_cpu).max())
    n = len(found)
    print(f"  silhouette over {n} cells ({n * n / 1e6:.0f}e6 distances): "
          f"card {card_s * 1e3:.1f} ms, CPU {cpu_s * 1e3:.1f} ms (host "
          f"clock, f64); overall {overall:.6f}; card vs CPU samples "
          f"{d_smp:.2e}, per cluster {d_per:.2e}, overall "
          f"{abs(overall - overall_cpu):.2e}; LDA and QDA {lda_s:.2f} s; "
          f"{card}")
    check(max(d_smp, d_per, abs(overall - overall_cpu)) <= TOL_SILH
          and bool(np.isfinite(smp_card).all()),
          f"get_SilhScore on the card equals the CPU call within "
          f"{TOL_SILH:g}")
    fig, smp, sil, size = ca.cluster_compare(xd, label_sets,
                                             num_pc=CLUS_PC)
    _, smp_cpu, sil_cpu, size_cpu = ca.cluster_compare(
        x_low, label_sets, num_pc=CLUS_PC, device="cpu")
    d_pca = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(smp + [sil], smp_cpu + [sil_cpu]))
    print(f"  cluster_compare ({CLUS_PC} PCs): silhouettes "
          f"{[round(v, 6) for v in sil]}, card vs CPU {d_pca:.2e}; {card}")
    check(fig is None and d_pca <= TOL_PCA_SILH
          and all(int(c.sum()) == n for c in size)
          and all(np.array_equal(a, b) for a, b in zip(size, size_cpu)),
          f"cluster_compare on the card equals the CPU call within "
          f"{TOL_PCA_SILH:g}; cluster sizes cover every cell")
    num = [r["n_classes"] for r in levels]
    ami = np.array([r["ami"] for r in levels]).T      # (A, levels)
    con = ami.mean(axis=0)
    ordered, _, ordered_con, K = ca.K_selection(num, ami, con,
                                                thr=float(np.median(con)))
    print(f"  K_selection over the study's {len(num)} levels (consensus: "
          f"the arms' mean AMI, thr its median): K = {K}")
    check(list(ordered) == sorted(num) and K in num
          and bool(np.all(np.diff(ordered) >= 0)),
          "K_selection orders the levels and picks one of them")
    try:
        import sklearn  # noqa: F401
        has_sklearn = True
    except ImportError:
        has_sklearn = False
    if has_sklearn:
        acc, _, _ = ca.kfold_classifier(x_low, label_sets, kfold=CLUS_KFOLD,
                                        kind="rf")
        check(all(0.0 <= a <= 1.0 for v in acc.values() for a in v),
              "rf (scikit-learn present): accuracies in [0, 1]")
    else:
        try:
            ca.kfold_classifier(x_low, label_sets, kfold=CLUS_KFOLD,
                                kind="rf")
            raised = None
        except ImportError as e:
            raised = str(e)
        check(raised is not None and "scikit-learn" in raised,
              f"rf without scikit-learn raises ImportError naming it: "
              f"{raised!r}")
    counts["clusterability"] = launched = launch_counts()
    check(not any(launched.values()),
          f"clusterability launches no kernel: {launched}")
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s; {card}")
    return counts


def main() -> int:
    only = [a for a in sys.argv[1:] if a.startswith("--kernels-only")]
    kernels_only = bool(only)
    # --kernels-only=decoder,coupling: just those kernel phases
    wanted = (only[0].split("=", 1)[1].split(",")
              if only and "=" in only[0] else None)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import dvae_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    check = Checks()
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_build(check)
        records = {}
        kernel_phases = (
            ("recon_fwd", lambda: {"recon_fwd": phase_kernels(torch, check)}),
            ("encoder", lambda: phase_encoder(torch, check)),
            ("recon_fwdbwd", lambda: {
                "recon_fwdbwd": phase_recon_fwdbwd(torch, check)}),
            ("recon_bwd", lambda: {
                "recon_bwd": phase_recon_bwd(torch, check)}),
            ("zinb", lambda: phase_zinb(torch, check)),
            ("gumbel", lambda: phase_gumbel(torch, check)),
            ("coupling", lambda: {"coupling": phase_coupling(torch, check)}),
            ("decoder", lambda: phase_decoder(torch, check)),
            ("c6", lambda: {"c6": phase_c6(torch, check)}))
        for name, run in kernel_phases:
            if wanted is None or name in wanted:
                records.update(run())
        if not kernels_only:
            served, ds, x, mse_ckpt = phase_serving(torch, check, tmp)
            ref_labels = ds.cluster_label[:N_GEN].copy()
            del ds
            paths = {"serving": served,
                     "training": phase_training(torch, check, tmp, x)}
            zinb, x_zinb = phase_zinb_path(torch, check, tmp)
            paths["zinb_training"] = zinb["training"]
            paths["zinb_serving"] = zinb["serving"]
            cat = phase_categorical_path(torch, check, tmp, x, x_zinb)
            paths["categorical_training"] = cat["training"]
            paths["categorical_serving"] = cat["serving"]
            paths["categorical_zinb"] = cat["zinb"]
            pallas_ckpt = cat["checkpoint"]
            paths.update(phase_wide_categories(torch, check, tmp, x))
            paths.update(phase_many_arms(torch, check, tmp, x))
            phase_augmenter(torch, check, x, x_zinb)
            paths.update(phase_c6_path(torch, check, tmp, x, x_zinb))
            zinb_host = x_zinb[:N_STREAM_ZINB + N_VAL].cpu()
            del x_zinb
            torch.cuda.empty_cache()
            paths.update(phase_decoder_path(torch, check, tmp, x))
            x_analysis = x[:N_EVALS2].cpu().numpy()
            del x
            torch.cuda.empty_cache()
            paths.update(phase_streaming(torch, check, tmp, zinb_host))
            del zinb_host
            paths.update(phase_gan(torch, check, tmp))
            torch.cuda.empty_cache()
            analysis, latent = phase_analysis(torch, check, tmp, x_analysis,
                                              mse_ckpt, pallas_ckpt)
            paths.update(analysis)
            del x_analysis
            torch.cuda.empty_cache()
            paths.update(phase_taxonomy(torch, check, tmp,
                                        (*latent, ref_labels)))
            on_path = ("recon_fwd", "recon_fwdbwd", "encoder_fwd",
                       "encoder_bwd", "zinb_fwd", "zinb_fwdbwd",
                       "gumbel_fwd", "gumbel_bwd", "coupling",
                       "decoder_fwd", "decoder_fwdbwd")
            for name in on_path:
                n = sum(c[name] for c in paths.values())
                check(n > 0, f"{name}: {n} launches on the driven paths")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed:",
              file=sys.stderr)
        for what in check.failed:
            print(f"  {what}", file=sys.stderr)
        return 1
    if kernels_only:
        print("chip_smoke: --kernels-only: kernel checks passed; the paths "
              "were not driven", file=sys.stderr)
        return 3
    sources = {
        "recon_fwd": ("recon_fwd.cu", "dvae_tpu/ops/recon_pallas.py:72"),
        "recon_fwdbwd": ("recon_fwdbwd.cu",
                         "dvae_tpu/ops/recon_pallas.py:239"),
        "recon_bwd": ("recon_fwdbwd.cu", "dvae_tpu/ops/recon_pallas.py:143"),
        "encoder_fwd": ("encoder_fc1.cu",
                        "dvae_tpu/ops/encoder_pallas.py:81"),
        "encoder_bwd": ("encoder_fc1.cu",
                        "dvae_tpu/ops/encoder_pallas.py:137"),
        "zinb_fwd": ("zinb_fwd.cu", "dvae_tpu/ops/zinb_pallas.py:269"),
        "zinb_fwdbwd": ("zinb_fwdbwd.cu", "dvae_tpu/ops/zinb_pallas.py:450"),
        "zinb_bwd": ("zinb_fwdbwd.cu", "dvae_tpu/ops/zinb_pallas.py:338"),
        "gumbel_fwd": ("gumbel.cu", "dvae_tpu/ops/gumbel_pallas.py:52"),
        "gumbel_bwd": ("gumbel.cu", "dvae_tpu/ops/gumbel_pallas.py:128"),
        "gumbel_sharpen": ("gumbel.cu", "dvae_tpu/ops/gumbel_pallas.py:203"),
        "coupling": ("coupling.cu", "dvae_tpu/ops/coupling_pallas.py:51"),
        "decoder_fwd": ("decoder.cu", "dvae_tpu/ops/decoder_pallas.py:115"),
        "decoder_fwdbwd": ("decoder.cu",
                           "dvae_tpu/ops/decoder_pallas.py:211"),
    }
    entries = {name: {"name": name, "route": "cuda",
                      "source": f"dvae_tpu_torch/csrc/{src}", "replaces": rep,
                      "launches": sum(c[name] for c in paths.values()),
                      "launches_by_path": {k: c[name]
                                           for k, c in paths.items()},
                      **records[name]}
               for name, (src, rep) in sources.items()}
    # the separate backward kernels and the sharpen variant of the Gumbel
    # forward have no caller on any path of either package; they are held
    # against their plain versions in phase 2 and listed apart, with the
    # same keys
    print(json.dumps({
        "kernels": [entries[n] for n in on_path],
        "kernels_off_path": [entries[n] for n in sources
                             if n not in on_path]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
