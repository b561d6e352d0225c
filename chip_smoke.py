#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dvae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits non-zero and prints no result line):
  1. build every CUDA kernel of the serving path from ``dvae_tpu_torch/csrc``;
  2. hold each kernel against its plain PyTorch version at the shapes the
     serving path gives it (f32 and bf16, shared and per-arm targets, a
     ragged batch), and time kernel, plain version and library call;
  3. drive the serving path end to end at the production width (A=5 arms,
     D=5032 genes, F=100, L=10, C=92, S=2; random weights from a seed):
     init → save_checkpoint → a fresh CplMixVAE.load_model → eval_model over
     42,000 synthetic cells (one 8-batch runner chunk plus a 2,000-row
     tail), with launch counts reset just before and read just after, and
     check the result against the port's CPU path on a small input;
  4. print the kernels line, the card's name and power limit, and last the
     ``{"ok": true, "device": ...}`` line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 0
A, B, F, D, C = 5, 5000, 100, 5032, 92
N_CELLS, TAIL = 42000, 2000
N_SMALL = 2000
# NVIDIA H100 SXM data sheet: dense peaks and HBM3 rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
TOL_SUMSQ = {"float32": 1e-5, "bfloat16": 1e-4}   # relative, per arm
TOL_MISM = 1e-5                                    # × B·D, per arm


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


def recon_bound_ms(a, b, f, d, dtype_name: str, per_arm_x: bool):
    """(bound_ms, bound_by) of one fused recon forward: operands read once,
    the (A, 2) output written once; 2·A·B·F·D operations of the product."""
    item = 4 if dtype_name == "float32" else 2
    x_elems = (a if per_arm_x else 1) * b * d
    nbytes = (a * b * f + a * f * d + a * d + x_elems) * item + a * 2 * 4
    flops = 2.0 * a * b * f * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


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


def phase_kernels(torch, check) -> dict:
    """Kernel vs plain version; returns the record of the main case."""
    from dvae_tpu_torch.ops.recon import fused_recon_mse, recon_mse_reference
    print("phase 2: recon_fwd kernel vs plain version")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for rows in (B, TAIL):
            for per_arm in (False, True):
                h = torch.rand((A, rows, F), generator=g, device=dev)
                w = (torch.rand((A, F, D), generator=g, device=dev) - 0.5) * 0.2
                b = (torch.rand((A, D), generator=g, device=dev) - 0.5) * 0.2
                xs = (A, rows, D) if per_arm else (rows, D)
                x = torch.relu(torch.randn(xs, generator=g, device=dev))
                h, w, b, x = (t.to(dtype).contiguous() for t in (h, w, b, x))
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
                    plain = cuda_ms(torch,
                                    lambda: recon_mse_reference(h, w, b, x),
                                    iters=5)
                    bias3 = b[:, None, :]
                    lib = cuda_ms(torch,
                                  lambda: torch.baddbmm(bias3, h, w), iters=10)
                    bound, by = recon_bound_ms(A, rows, F, D, dname, per_arm)
                    err = max((sk - sp).abs().max().item(), dm)
                    print(f"  {tag}: kernel_ms {ms:.4f} plain_ms {plain:.4f} "
                          f"library_ms(baddbmm product) {lib:.4f} "
                          f"bound_ms {bound:.4f} ({by}) "
                          f"share_of_bound {bound / ms:.3f}")
                    if dtype == torch.float32:
                        record = {"max_abs_err": err, "ms": ms,
                                  "plain_ms": plain, "bound_ms": bound,
                                  "bound_by": by, "library_ms": lib}
                del h, w, b, x
    torch.cuda.empty_cache()
    return record


def phase_breakdown(torch, server, x) -> None:
    """Where the serving time goes: a warm eval_model run timed on the host
    clock, then one under torch.profiler with device time by kernel name
    and the device-busy share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    server.eval_model(x, batch_size=B)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"  warm eval_model: {warm:.4f} s = {N_CELLS / warm:.1f} cells/s")
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


def phase_serving(torch, check, tmp) -> int:
    """Serving path end to end; returns the kernel's launch count."""
    import numpy as np
    from dvae_tpu_torch.data.anndata_io import synthetic_dataset
    from dvae_tpu_torch.ops.recon import fused_recon_mse
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    print("phase 3: serving path end to end")
    trainer = CplMixVAE(saving_folder=tmp, device="cuda", seed=SEED)
    trainer.init_model(n_arm=A, n_categories=C, input_dim=D, fc_dim=F,
                       lowD_dim=10, state_dim=2, batch_size=B)
    ckpt = trainer.save_checkpoint("smoke")
    del trainer
    server = CplMixVAE(device="cuda")
    server.load_model(ckpt)
    check(server.cfg.fused_recon, "loaded model serves through the kernel")

    t0 = time.perf_counter()
    ds = synthetic_dataset(n_cells=N_CELLS, n_genes=D, n_types=C, seed=SEED)
    x = torch.as_tensor(ds.log1p).to("cuda")
    torch.cuda.synchronize()
    print(f"  synthetic dataset {tuple(x.shape)} resident on the card "
          f"({time.perf_counter() - t0:.1f} s to make)")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    fused_recon_mse.launches = 0
    t0 = time.perf_counter()
    res = server.eval_model(x, batch_size=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_recon_mse.launches
    rise = torch.cuda.max_memory_allocated() - base

    print(f"  eval_model: {N_CELLS} cells in {wall:.4f} s = "
          f"{N_CELLS / wall:.1f} cells/s; consensus {res['consensus']:.6f}; "
          f"total_loss {res['total_loss']:.6g}")
    check(launches == 9, f"recon_fwd launches on the serving path: {launches} "
                         "(expect 9: one 8-batch chunk + the tail)")
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

    # reference: the port's CPU path (plain PyTorch) on a small input
    small = ds.log1p[:N_SMALL]
    ref = CplMixVAE(device="cpu")
    ref.load_model(ckpt)
    want = ref.eval_model(small, batch_size=B)
    got = server.eval_model(x[:N_SMALL], batch_size=B)
    agree = got["pred_label"] == want["pred_label"]
    check(float(agree.mean()) >= 0.999,
          f"labels vs CPU path on {N_SMALL} cells: agreement "
          f"{float(agree.mean()):.6f} (min 0.999)")
    rows = np.all(agree, axis=0)
    dc = float(np.abs(got["c_prob"][:, rows] - want["c_prob"][:, rows]).max())
    check(dc <= 1e-3, f"c_prob vs CPU path: max abs diff {dc:.2e} (tol 1e-3)")
    dmu = float(np.abs(got["state_mu"] - want["state_mu"]).max())
    check(dmu <= 1e-3, f"state_mu vs CPU path: max abs diff {dmu:.2e} "
                       "(tol 1e-3)")
    rl = float(np.max(np.abs(got["total_loss_rec"] - want["total_loss_rec"])
                      / np.abs(want["total_loss_rec"])))
    check(rl <= 1e-3, f"total_loss_rec vs CPU path: max rel diff {rl:.2e} "
                      "(tol 1e-3)")
    return launches


def main() -> int:
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
        record = phase_kernels(torch, check)
        launches = phase_serving(torch, check, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed:",
              file=sys.stderr)
        for what in check.failed:
            print(f"  {what}", file=sys.stderr)
        return 1
    kernels = [{"name": "recon_fwd", "route": "cuda",
                "source": "dvae_tpu_torch/csrc/recon_fwd.cu",
                "replaces": "dvae_tpu/ops/recon_pallas.py:72",
                "launches": launches, **record}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
