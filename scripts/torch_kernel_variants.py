#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels #5 (encoder_bwd) and #6
(zinb_fwd) against each other on one NVIDIA GPU.

    python3 scripts/torch_kernel_variants.py encoder_stages zinb_blocks

Each named set lists variants of ``dvae_tpu_torch/csrc``: regular-expression
substitutions applied to a copy of the sources under
``runs/kernel_variants/<set>/<variant>/`` (``runs/`` is not committed); the
first variant of a set is the sources as they are.  Every variant's
libraries are built with one ``nvcc`` each, all started together; then
the variants run in turns (first to last, then last to first), each
checked against the plain version before it is timed: #5 dW1 within 1e-5
of the plain version fed the same mask, #6's value within 1e-5 and equal
to #7's loss bit for bit.  Shapes are the production ones (A=5, B=5000,
D=5032, F=100); times by CUDA events.  Exits 2 without a card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SETS = {
    # stage depth of #5's backward: rows of x and g a stage
    "encoder_stages": ("encoder_fc1", {
        "f32 32 rows, bf16 64 (as built)": [],
        "f32 16 rows, bf16 32": [
            ("encoder_fc1.cu", r"int RK = 32;    // rows a stage",
             "int RK = 16;    // rows a stage"),
            ("encoder_fc1.cu", r"int RK = 64;", "int RK = 32;")],
    }),
    # blocks an SM of #6's value-only row pass (its launch bounds; the
    # training form keeps 4)
    "zinb_blocks": ("zinb_fwd", {
        "4 (as built)": [],
        "5": [("zinb_rows.cuh", r"__launch_bounds__\(THREADS1, 4\)",
               "__launch_bounds__(THREADS1, FT > 0 ? 4 : 5)")],
        "6 (bf16; f32 holds 5 by its shared memory)": [
            ("zinb_rows.cuh", r"__launch_bounds__\(THREADS1, 4\)",
             "__launch_bounds__(THREADS1, FT > 0 ? 4 : 6)")],
    }),
    # the row pass's tile loads (#6, and #7's pass 1): the loader shaped at
    # compile time or the generic one
    "zinb_loader": ("zinb_fwd", {
        "tc::load_tile_c (as built)": [],
        "tc::load_tile": [
            ("zinb_rows.cuh",
             r"tc::load_tile_c<C::BN1, THREADS1>\(\s*st \+ hd \* w_elems, "
             r"C::LDW1,\s*heads\.w\[hd\] \+ \(long long\)a \* F \* D "
             r"\+ col0, D, FK, F, D - col0,\s*vec_d, tid\);",
             "tc::load_tile(st + hd * w_elems, C::LDW1, heads.w[hd] + "
             "(long long)a * F * D + col0, D, FK, C::BN1, F, D - col0, "
             "vec_d, tid, THREADS1);"),
            ("zinb_rows.cuh",
             r"tc::load_tile_c<C::BN1, THREADS1>\(st \+ 3 \* w_elems, "
             r"C::LDX1,\s*xa \+ \(long long\)m0 \* D \+ col0, D, BM1,"
             r"\s*B - m0, D - col0, vec_d, tid\);",
             "tc::load_tile(st + 3 * w_elems, C::LDX1, xa + (long long)m0 "
             "* D + col0, D, BM1, C::BN1, B - m0, D - col0, vec_d, tid, "
             "THREADS1);")],
    }),
}
A, B, D, F = 5, 5000, 5032, 100
RATE = 0.5


def make_variant(root: Path, edits) -> Path:
    from dvae_tpu_torch.ops import _build
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(_build.CSRC, root, ignore=shutil.ignore_patterns("build"))
    for name, pattern, repl in edits:
        path = root / name
        text, n = re.subn(pattern, repl, path.read_text())
        if n == 0:
            raise SystemExit(f"{root.name}: {pattern!r} matches nothing in "
                             f"{name}")
        path.write_text(text)
    (root / "build").mkdir()
    return root


def build_all(variants, names) -> None:
    from dvae_tpu_torch.ops import _build
    procs = []
    for label, root in variants.items():
        for name in names:
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                   str(root / "build" / f"lib{name}.so"),
                   str(root / f"{name}.cu")]
            procs.append((label, name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for label, name, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {label} {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {label} {name}: {line.strip()}")


def use(root: Path) -> None:
    """Point the kernel loader at one variant's libraries."""
    from dvae_tpu_torch.ops import _build
    _build.CSRC = root
    _build._loaded.clear()
    _build.library_path = lambda name: root / "build" / f"lib{name}.so"


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dvae_tpu_torch.ops import encoder as enc
    from dvae_tpu_torch.ops import zinb

    names = argv or list(SETS)
    unknown = [n for n in names if n not in SETS]
    if unknown:
        print(f"unknown sets {unknown}; known: {list(SETS)}", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(3)
    x32 = torch.relu(torch.randn((B, D), generator=g, device="cuda"))
    gy32 = torch.randn((A, B, F), generator=g, device="cuda")
    ops32 = cs.zinb_inputs(torch, g, torch.float32, B, False)
    out = REPO / "runs" / "kernel_variants"
    for set_name in names:
        kernel, table = SETS[set_name]
        variants = {label: make_variant(out / set_name / f"v{i}", edits)
                    for i, (label, edits) in enumerate(table.items())}
        print(f"{set_name}: building {len(variants)} variants of {kernel}")
        build_all(variants, [kernel] + (["zinb_fwdbwd"]
                                        if kernel == "zinb_fwd" else []))
        times = {label: {} for label in variants}
        order = list(variants)
        for labels in (order, order[::-1]):
            for label in labels:
                use(variants[label])
                for dt in (torch.float32, torch.bfloat16):
                    key = "f32" if dt == torch.float32 else "bf16"
                    rec = times[label]
                    if kernel == "encoder_fc1":
                        x, gy = x32.to(dt), gy32.to(dt)
                        m = enc.kernel_keep_mask(11, (A, B, D), RATE, "cuda")
                        err = cs.rel_err(torch, enc.encoder_bwd(
                            11, x, gy, RATE)[0],
                            enc.dropout_fc1_grad_reference(x, gy, RATE, m)[0])
                        del m
                        if err > 1e-5:
                            raise SystemExit(f"{label} {key}: rel err {err}")
                        rec.setdefault(f"{key} Philox", []).append(
                            cs.cuda_ms(torch, lambda: enc.encoder_bwd(
                                11, x, gy, RATE)))
                        rec.setdefault(f"{key} no mask", []).append(
                            cs.cuda_ms(torch, lambda: enc.encoder_bwd(
                                11, x, gy, 0.0)))
                    else:
                        ops = [t.to(dt) for t in ops32]
                        v = zinb.fused_zinb(*ops, cs.ZINB_EPS)
                        v0 = zinb.zinb_heads_plain(*ops, cs.ZINB_EPS)
                        err = ((v - v0).abs() / v0.abs()).max().item()
                        same = torch.equal(
                            v, zinb.zinb_fwdbwd(*ops, cs.ZINB_EPS)[0])
                        if err > 1e-5 or not same:
                            raise SystemExit(f"{label} {key}: rel err {err}, "
                                             f"equal to #7's loss {same}")
                        rec.setdefault(key, []).append(cs.cuda_ms(
                            torch, lambda: zinb.fused_zinb(*ops, cs.ZINB_EPS),
                            iters=10))
                        del ops
        for label, rec in times.items():
            print(f"  {set_name} | {label} | " + " | ".join(
                f"{k} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                for k, ts in rec.items()))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
