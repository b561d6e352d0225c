#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels #1 (recon_fwd), #2
(recon_fwdbwd), #5 (encoder_bwd), #6 (zinb_fwd), #9 and #10 (gumbel) and
#11 (coupling) against each other on one NVIDIA GPU.

    python3 scripts/torch_kernel_variants.py --base runs/old gumbel

    python3 scripts/torch_kernel_variants.py recon_slices encoder_stages
    python3 scripts/torch_kernel_variants.py --base runs/old recon_quiet
    python3 scripts/torch_kernel_variants.py --base runs/old recon_fwd recon_c5

Each named set lists variants of ``dvae_tpu_torch/csrc``: regular-expression
substitutions applied to a copy of the sources under
``runs/kernel_variants/<set>/<variant>/`` (``runs/`` is not committed); the
first variant of a set is the sources as they are.  Every variant's
libraries are built with one ``nvcc`` each, all started together; then
the variants run in turns (first to last, then last to first), each
checked against the plain version before it is timed: #2 within the chip
check's limits on the uniform draw (sums; dh on the rows, dW and db on the
columns whose plain y stay clear of the ReLU kink) and on a draw on which
y is exact in any order (every output), #5 dW1 within 1e-5 of the plain
version fed the same mask, #6's value within 1e-5 and equal to #7's loss
bit for bit. #1 is checked within the chip check's limits
(sumsq 1e-5, mism 1e-5 of B·D) and timed beside the value-only row pass
of #2 that #12 runs, on the same inputs (``chip_smoke.row_pass_value``),
with its launches' device times by kernel (prep, tiles, reduction).  Set
``recon_c5`` holds #2, #3 (cotangent 1.5), #12 and #13 on the uniform
and the grid draws, f32 and bf16, bit for bit against the first
variant's outputs (with ``--base``: an earlier build's), and times #2 and
#13.  The sets in TIMING_ONLY are ablations: their variants after
the first drop work to show where the time goes, so only the first is
checked.  ``--base DIR`` adds to every set one more variant, the sources
of another checkout (``DIR/dvae_tpu_torch/csrc``, e.g. a ``git archive``
of an earlier commit) as they are; for #2 every checked variant's outputs
on the uniform draw are also compared with the first variant's, bit for
bit.  Set ``gumbel`` holds #9 (seeded soft sample, hard sample on given
uniforms) within TOL_GUMBEL of its plain version, records its uniforms and
its seeded launch against the numpy twin's uniforms bit for bit, and with
``--base`` holds #9 within TOL_GUMBEL and #10 bit for bit (C = 92 and 300)
against the earlier build's outputs.  Shapes are the production ones
(A=5, B=5000, D=5032, F=100, C=92);
times by CUDA events, and #2's passes also by the profiler's device time.
Exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SETS = {
    # the 3xTF32 split of #2's products: integer rounding (the same bits)
    # or cvt.rna.tf32.f32, as #4-#8 split
    "recon_split": ("recon_fwdbwd", {
        "integer rounding (as built)": [],
        "cvt.rna": [("recon_passes.cuh", r"tc::split_a_bits\(",
                     "tc::split_a("),
                    ("recon_passes.cuh", r"tc::split_b_bits\(",
                     "tc::split_b(")],
    }),
    # #2's row plan: slices of D to fill whole waves, or none
    "recon_slices": ("recon_fwdbwd", {
        "plan (as built)": [],
        "one slice": [("recon_passes.cuh", r"constexpr int MAX_SPLIT = 8;",
                       "constexpr int MAX_SPLIT = 1;")],
    }),
    # where #2's time goes: each ablation drops one piece of work (its
    # outputs are wrong by design, so they are timed, not checked)
    "recon_ablate": ("recon_fwdbwd", {
        "as built": [],
        "no streamed loads (stages after the first never refilled)": [
            ("recon_passes.cuh",
             r"if \(step \+ 1 < nsteps\) issue\(step \+ 1\);", ""),
            ("recon_passes.cuh",
             r"if \(step \+ S - 1 < nsteps\) issue\(step \+ S - 1\);", "")],
        "no y products (both passes)": [
            ("recon_passes.cuh", r"if \(k0 >= FK\) break;", "break;"),
            ("recon_passes.cuh", r"if \(kk >= FK\) break;", "break;")],
        "no dh products (pass 1)": [
            ("recon_passes.cuh", r"if \(8 \* n < FK\) \{", "if (false) {")],
        "no dW products (pass 2)": [
            ("recon_passes.cuh", r"if \(has_m0\) \{", "if (false) {")],
        "1xTF32 (the two lo products dropped; f32 only)": [
            ("mma.cuh", r"  mma_tf32\(small, a\.lo, b\.hi\);\n"
             r"  mma_tf32\(big, a\.hi, b\.hi\);\n"
             r"  mma_tf32\(small, a\.hi, b\.lo\);",
             "  mma_tf32(big, a.hi, b.hi);")],
    }),
    # what keeping a NaN through #2's integer split costs: the passes read
    # copies of h and W with every NaN quiet (csrc/recon_passes.cuh
    # quiet_copy), or the operands themselves
    "recon_quiet": ("recon_fwdbwd", {
        "quiet copies (as built)": [],
        "no copies": [
            ("recon_passes.cuh",
             r"if \(std::is_same<T, float>::value && quiet_ws\) \{",
             "if (false) {")],
    }),
    # kernel #1 on wgmma: where its time goes (ablations after the first
    # drop one piece of work; timed, not checked)
    "recon_fwd": ("recon_fwd", {
        "as built": [],
        "1xTF32 (the two lo products dropped; f32 only)": [
            ("recon_fwd.cu", r"\n\s*wg::mma_tf32\(small, al \+ o, bh \+ o\);"
             r"\n\s*wg::mma_tf32\(small, ah \+ o, bl \+ o\);", "")],
        "no epilogue": [
            ("recon_fwd.cu", r"      if \(with_mism\) \{\n        if \(edge\)",
             "      if (false) {\n        if (edge)"),
            ("recon_fwd.cu", r"      \} else \{\n        if \(edge\)\n"
             r"          epilogue_f<false",
             "      } else if (false) {\n        if (edge)\n"
             "          epilogue_f<false")],
        "x and bias not loaded": [
            ("recon_fwd.cu", r"if \(c == nk - 1\) \{",
             "if (c == nk - 1) {\n#pragma unroll\n for (int jj = 0; jj < 8; "
             "++jj)\n#pragma unroll\n for (int q = 0; q < 2; ++q) { bv[jj][q] "
             "= 0.f; xv[jj][0][q] = xv[jj][1][q] = 0.f; }\n }\n if (false) {"),
            ("recon_fwd.cu", r"const bool with_x = xs && c == nk - 1;",
             "const bool with_x = false;")],
        "no products": [
            ("recon_fwd.cu", r"for \(int ks = 0; ks < kc / KS; \+\+ks\)",
             "for (int ks = 0; ks < 0; ++ks)")],
        "no prep launches": [
            ("recon_fwd.cu", r"int err = prep<T>\(", "int err = 0; if (0) prep<T>("),
            ("recon_fwd.cu", r"\n  err = prep<T>\(", "\n  if (0) prep<T>(")],
    }),
    # fault C5's repair (gm made quiet where it is split): the same bits
    # as before it on inputs without a NaN, with --base
    "recon_c5": ("recon_c5", {
        "quiet gm (as built)": [],
        "gm as computed": [
            ("recon_passes.cuh",
             r"if constexpr \(F32 && DH\) gmv = tc::quiet_nan\(gmv\);", ""),
            ("recon_passes.cuh",
             r"make_float2\(tc::quiet_nan\(gv\[0\]\), tc::quiet_nan\(gv\[1\]\)\)",
             "make_float2(gv[0], gv[1])")],
    }),
    # fault C6's repair (the wide forms, template flags off at F <= 128):
    # with --base, #2, #3, #6, #7, #8, #12 and #13 at F = 100 the same bits
    # as before it, and their times
    "c6": ("c6", {"as built": []}),
    # kernel #11 in one cooperative launch; with --base, the four launches
    # it replaced, timed in the same call
    "coupling": ("coupling", {
        "16 warps a block (as built)": [],
        "8 warps a block": [("coupling.cu", r"constexpr int WARPS = 16;",
                             "constexpr int WARPS = 8;")],
        "32 warps a block": [("coupling.cu", r"constexpr int WARPS = 16;",
                              "constexpr int WARPS = 32;")],
    }),
    # kernel #9's redesign: the row plan's lanes a row (4, 16, or 32 as the
    # one-warp-a-row kernel it replaced), IEEE divisions by T and the row
    # sum in place of one reciprocal each, the grid (one row group a block,
    # or the striding grid with 2 or 4 blocks an SM; 8 as built, which at
    # C=92 is one group a block), 4 warps a block, and launch bounds for 6
    # blocks an SM; with --base, the kernels it replaced, in the same call
    "gumbel": ("gumbel", {
        "plan: 8 lanes of 3 quads at C=92, 8 blocks an SM (as built)": [],
        "4 lanes a row": [("gumbel.cu", r"for \(int lanes = 1; lanes <= 32;",
                           "for (int lanes = 4; lanes <= 4;")],
        "16 lanes a row": [("gumbel.cu", r"for \(int lanes = 1; lanes <= 32;",
                            "for (int lanes = 16; lanes <= 16;")],
        "32 lanes a row": [("gumbel.cu", r"for \(int lanes = 1; lanes <= 32;",
                            "for (int lanes = 32; lanes <= 32;")],
        "IEEE divisions by T and the row sum": [
            ("gumbel.cu", r"const float inv_t = 1\.f / ",
             "const float inv_t = "),
            ("gumbel.cu", r"\+ gn\) \* inv_t;", "+ gn) / inv_t;"),
            ("gumbel.cu", r"const float inv_s = 1\.f / seg_sum",
             "const float inv_s = seg_sum"),
            ("gumbel.cu", r"v\[j\]\[k\] = v\[j\]\[k\] \* inv_s;",
             "v[j][k] = v[j][k] / inv_s;")],
        "one row group a block (no striding, no prefetch)": [
            ("gumbel.cu", r"constexpr int BLOCKS_PER_SM = 8;",
             "constexpr int BLOCKS_PER_SM = 1 << 20;")],
        "2 blocks an SM": [("gumbel.cu", r"constexpr int BLOCKS_PER_SM = 8;",
                            "constexpr int BLOCKS_PER_SM = 2;")],
        "4 blocks an SM": [("gumbel.cu", r"constexpr int BLOCKS_PER_SM = 8;",
                            "constexpr int BLOCKS_PER_SM = 4;")],
        "4 warps a block": [("gumbel.cu", r"constexpr int WARPS = 8;",
                             "constexpr int WARPS = 4;")],
        "launch bounds for 6 blocks an SM": [
            ("gumbel.cu", r"__launch_bounds__\(THREADS\) gumbel_fwd_rows",
             "__launch_bounds__(THREADS, 6) gumbel_fwd_rows")],
    }),
    # where #11's time goes: each ablation drops one piece of work (its
    # outputs are wrong by design, so they are timed, not checked)
    "coupling_ablate": ("coupling", {
        "as built": [],
        "no phase-0 sums": [
            ("coupling.cu", r"for \(int pr = tid; pr < AC;",
             "for (int pr = tid; pr < 0;")],
        "no w and m (the second barrier kept)": [
            ("coupling.cu", r"for \(int col = blk; col < C; col \+= nb\)",
             "for (int col = blk; col < 0; col += nb)")],
        "one grid barrier (the second removed)": [
            ("coupling.cu", r"    __syncthreads\(\);\n  \}\n  grid\.sync\(\);",
             "    __syncthreads();\n  }")],
        "no phase-1 products": [
            ("coupling.cu", r"for \(int i = tid; i < n; i \+= THREADS\) \{\n"
             r"      const int col = i % C;",
             "for (int i = tid; i < 0; i += THREADS) {\n"
             "      const int col = i % C;")],
    }),
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
TIMING_ONLY = {"recon_ablate", "recon_fwd", "coupling_ablate"}
LIBRARIES = {"recon_c5": ["recon_fwdbwd", "decoder"],
             "c6": ["recon_fwdbwd", "decoder", "zinb_fwd", "zinb_fwdbwd"],
             "zinb_fwd": ["zinb_fwd", "zinb_fwdbwd"],
             "recon_fwd": ["recon_fwd", "recon_fwdbwd"]}
A, B, D, F = 5, 5000, 5032, 100
RATE = 0.5


def make_variant(root: Path, edits, src=None) -> Path:
    from dvae_tpu_torch.ops import _build
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(src or _build.CSRC, root,
                    ignore=shutil.ignore_patterns("build"))
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
    """Point the kernel loader at one variant's libraries.  #2's entry
    points of sources from before the quiet copies take no workspace:
    their calls drop it; #1's of sources from before its workspace take
    two partial buffers instead: their calls split it."""
    from dvae_tpu_torch.ops import _build, recon
    _build.CSRC = root
    _build._loaded.clear()
    _build.library_path = lambda name: root / "build" / f"lib{name}.so"
    src = root / "recon_fwd.cu"
    if src.exists() and "recon_fwd_workspace_bytes" not in src.read_text():
        lib = _build.load("recon_fwd")
        lib.recon_fwd_partials_per_arm.argtypes = [ctypes.c_int] * 2
        lib.recon_fwd_partials_per_arm.restype = ctypes.c_longlong
        lib.recon_fwd_workspace_bytes = (
            lambda A, B, F, D, bf16: 8 * A * lib.recon_fwd_partials_per_arm(
                B, D))
        lib.recon_fwd_max_rows.restype = ctypes.c_longlong
        lib._dvae_bound = True
        for name in ("recon_fwd_f32", "recon_fwd_bf16"):
            raw = getattr(lib, name)
            raw.argtypes = recon._ARGTYPES[:-3] + [ctypes.c_void_p] * 4
            raw.restype = ctypes.c_int
            setattr(lib, name, lambda *a, raw=raw: raw(
                *a[:-3], a[-3], a[-3] + 4 * a[5] * lib.recon_fwd_partials_per_arm(
                    a[6], a[8]), a[-2], a[-1]))
    built = root / "build"
    src = root / "decoder.cu"
    if ((built / "libdecoder.so").exists()
            and "decoder_max_f" not in src.read_text()):
        # before the wide trunk: F <= 128, h_5 alone in the value-only
        # call's workspace, one gradient partial vector a row tile
        from dvae_tpu_torch.ops import decoder, zinb
        lib = _build.load("decoder")
        lib.decoder_grad_len.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.decoder_grad_len.restype = ctypes.c_longlong
        lib.decoder_max_f = lambda bf16, train: 128
        lib.decoder_acts_elems = lambda w, A, B, train: A * B * (
            sum(w[1:6]) if train else w[5])
        lib.decoder_grad_scratch_floats = lambda w, A, B: (
            A * -(-B // 64) * lib.decoder_grad_len(w))
        decoder._lib()
        zlib = _build.load("zinb_fwd")
        zlib.zinb_fwd_max_f = lambda bf16: 128
        zinb._lib_fwd()
    src = root / "coupling.cu"
    if ((built / "libcoupling.so").exists()
            and "coupling_buffer_floats" not in src.read_text()):
        # the four launches before #11's one: workspace and output apart;
        # the calls get them from the one buffer, the output first
        from dvae_tpu_torch.ops import coupling
        lib = _build.load("coupling")
        vp, i = ctypes.c_void_p, ctypes.c_int
        raw = lib.coupling_gram_f32
        raw.argtypes = [vp, ctypes.c_float, i, i, i, vp, vp, vp]
        raw.restype = i
        lib.coupling_workspace_floats.argtypes = [i, i, i]
        lib.coupling_workspace_floats.restype = ctypes.c_longlong
        lib.coupling_max_arms.restype = lib.coupling_max_c.restype = i
        lib.coupling_plan = lambda *args: -1
        lib.coupling_buffer_floats = (
            lambda A, B, C: 64 + lib.coupling_workspace_floats(A, B, C))
        lib.coupling_gram_f32 = (
            lambda c, eps, A, B, C, buf, st: raw(c, eps, A, B, C,
                                                 buf + 64 * 4, buf, st))
        lib._dvae_bound = True
        coupling._lib()
    src = root / "gumbel.cu"
    if ((built / "libgumbel.so").exists()
            and "gumbel_fwd_plan" not in src.read_text()):
        # before #9's row plan: no plan entry
        from dvae_tpu_torch.ops import gumbel
        lib = _build.load("gumbel")
        lib.gumbel_fwd_plan = lambda *args: -1
        gumbel._lib()
    src = root / "recon_fwdbwd.cu"
    if src.exists() and "quiet_ws" not in src.read_text():
        lib = _build.load("recon_fwdbwd")
        lib.recon_fwdbwd_quiet_ws_floats = lambda *args: 0
        recon._lib_fwdbwd()  # binds the entry points
        for name in ("recon_fwdbwd_f32", "recon_fwdbwd_bf16",
                     "recon_bwd_f32", "recon_bwd_bf16"):
            raw = getattr(lib, name)
            raw.argtypes = raw.argtypes[:-2] + raw.argtypes[-1:]
            setattr(lib, name,
                    lambda *args, raw=raw: raw(*args[:-2], args[-1]))


def pass_ms(torch, fn, iters: int = 5):
    """(name, device ms a launch) of #2's two passes under torch.profiler:
    each pass's device time over the launches the profiler recorded (one a
    call; a process that opens many profiler sessions can lose some)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total, count = {}, {}
    for e in prof.key_averages():
        name = re.search(r"recon_(rows|cols)\b", e.key)
        if e.device_type == cuda and name and e.count:
            k = name.group(0)
            total[k] = total.get(k, 0.0) + e.self_device_time_total / 1e3
            count[k] = count.get(k, 0) + e.count
    return [(k, total[k] / count[k]) for k in sorted(total)]


def time_recon_fwd(torch, cs, recon, rec32, dt, key, rec, checked):
    """#1 on the uniform draw: checked (as the chip check holds it) when
    ``checked``, timed, its launches' device time by kernel, and the
    value-only row pass of #2 on the same inputs."""
    h, w, b, x = (t.to(dt) for t in rec32[False])
    dname = str(dt)[6:]
    if checked:
        s, m = recon.fused_recon_mse(h, w, b, x)
        sp, mp = recon.recon_mse_reference(h, w, b, x)
        e_s = ((s - sp).abs() / sp.abs()).max().item()
        e_m = (m - mp).abs().max().item()
        if e_s > cs.TOL_SUMSQ[dname] or e_m > cs.TOL_MISM * B * D:
            raise SystemExit(f"recon_fwd {key}: sumsq rel err {e_s}, mism "
                             f"{e_m}")
    rec.setdefault(key, []).append(cs.cuda_ms(
        torch, lambda: recon.fused_recon_mse(h, w, b, x)))
    for name, v in sorted(cs.kernel_device_ms(
            torch, lambda: recon.fused_recon_mse(h, w, b, x)).items()):
        m_ = re.search(r"recon_fwd_[a-z]+", name)
        if m_:
            rec.setdefault(f"{key} {m_.group(0)}", []).append(v)
    if hasattr(recon._lib_fwdbwd(), "recon_rows_value_f32"):
        rec.setdefault(f"{key} row pass", []).append(cs.cuda_ms(
            torch, lambda: cs.row_pass_value(torch, h, w, b, x)))


def c5_outputs(torch, cs, dt):
    """Every output of #2, #3 (cotangent 1.5 an arm), #12 and #13 on the
    uniform draws and on the grid draws of chip_smoke.py (B = 2000,
    shared x), in type ``dt``."""
    from dvae_tpu_torch.ops import decoder as dec
    from dvae_tpu_torch.ops import recon
    outs = []
    for grid in (False, True):
        g = torch.Generator(device="cuda").manual_seed(7)
        ops = cs.recon_inputs(torch, g, dt, cs.TAIL, False, on_grid=grid)
        outs += list(recon.recon_fwdbwd(*ops))
        outs += list(recon.recon_bwd(
            torch.full((A,), 1.5, device="cuda"), *ops))
        d = cs.decoder_inputs(torch, g, dt, cs.TAIL, False, on_grid=grid)
        outs += list(dec.fused_decoder_mse(*d))
        t = dec.decoder_fwdbwd(d[0], [(d[1 + 2 * i], d[2 + 2 * i])
                                      for i in range(5)], d[11], d[12], d[13])
        outs += [t[0], t[1], t[2], *(u for pair in t[3] for u in pair),
                 t[4], t[5]]
        del ops, d, t
    return outs


def c5_times(torch, cs, rec32, dt, key, rec):
    """#2 on the uniform draw and #13 on the decoder's, production shape."""
    from dvae_tpu_torch.ops import decoder as dec
    from dvae_tpu_torch.ops import recon
    ops = [t.to(dt) for t in rec32[False]]
    rec.setdefault(f"{key} #2", []).append(cs.cuda_ms(
        torch, lambda: recon.recon_fwdbwd(*ops)))
    g = torch.Generator(device="cuda").manual_seed(8)
    d = cs.decoder_inputs(torch, g, dt, B, False)
    tr = [(d[1 + 2 * i], d[2 + 2 * i]) for i in range(5)]
    rec.setdefault(f"{key} #13", []).append(cs.cuda_ms(
        torch, lambda: dec.decoder_fwdbwd(d[0], tr, d[11], d[12], d[13])))
    del ops, d, tr


def c6_outputs(torch, cs, dt):
    """c5_outputs, and every output of #6, #7 and #8 (cotangents -1.5 ..
    2.5) on the uniform and the grid draws of chip_smoke.py (B = 2000,
    shared x, F = 100), in type ``dt``."""
    from dvae_tpu_torch.ops import zinb
    outs = c5_outputs(torch, cs, dt)
    cot = torch.linspace(-1.5, 2.5, A, device="cuda")
    for grid in (False, True):
        g = torch.Generator(device="cuda").manual_seed(9)
        ops = cs.zinb_inputs(torch, g, dt, cs.TAIL, False, on_grid=grid)
        heads = tuple(zip(ops[1:7:2], ops[2:7:2]))
        fb = zinb.zinb_fwdbwd(*ops, cs.ZINB_EPS)
        bw = zinb.zinb_bwd(cot, ops[0], heads, ops[7], cs.ZINB_EPS)
        outs += [zinb.fused_zinb(*ops, cs.ZINB_EPS), fb[0], *fb[1],
                 *fb[2], *fb[3], *bw[0:1], *bw[1], *bw[2]]
        del ops, heads, fb, bw
    return outs


def c6_times(torch, cs, rec32, ops32, dt, key, rec):
    """#2, #3, #6, #7, #8, #12, #13 at the production shape."""
    from dvae_tpu_torch.ops import decoder as dec
    from dvae_tpu_torch.ops import recon, zinb
    ops = [t.to(dt) for t in rec32[False]]
    cot = torch.full((A,), 1.5, device="cuda")
    rec.setdefault(f"{key} #2", []).append(cs.cuda_ms(
        torch, lambda: recon.recon_fwdbwd(*ops)))
    rec.setdefault(f"{key} #3", []).append(cs.cuda_ms(
        torch, lambda: recon.recon_bwd(cot, *ops)))
    zops = [t.to(dt) for t in ops32]
    heads = tuple(zip(zops[1:7:2], zops[2:7:2]))
    for name, fn in (
            ("#6", lambda: zinb.fused_zinb(*zops, cs.ZINB_EPS)),
            ("#7", lambda: zinb.zinb_fwdbwd(*zops, cs.ZINB_EPS)),
            ("#8", lambda: zinb.zinb_bwd(cot, zops[0], heads, zops[7],
                                         cs.ZINB_EPS))):
        rec.setdefault(f"{key} {name}", []).append(
            cs.cuda_ms(torch, fn, iters=10))
    g = torch.Generator(device="cuda").manual_seed(8)
    d = cs.decoder_inputs(torch, g, dt, B, False)
    tr = [(d[1 + 2 * i], d[2 + 2 * i]) for i in range(5)]
    rec.setdefault(f"{key} #12", []).append(cs.cuda_ms(
        torch, lambda: dec.fused_decoder_mse(*d)))
    rec.setdefault(f"{key} #13", []).append(cs.cuda_ms(
        torch, lambda: dec.decoder_fwdbwd(d[0], tr, d[11], d[12], d[13])))
    del ops, zops, heads, d, tr


def coupling_times(torch, cs, rec, checked):
    """#11 at (5, 5000, 92) against its plain version (Gram 2e-4,
    distance 1e-4 rel) when ``checked``, then its event and device times a
    call."""
    from dvae_tpu_torch.ops import coupling as cp
    g = torch.Generator(device="cuda").manual_seed(6)
    c = cs.categorical_posterior(torch, g, (A, B, cs.C))
    gram = cp.coupling_gram_fused(c, cs.GUMBEL_EPS)
    e = cs.rel_err(torch, gram, cp.coupling_gram_plain(c, cs.GUMBEL_EPS))
    d0 = cp.coupling_distance_plain(c, cs.GUMBEL_EPS).item()
    e_d = abs(cp.coupling_distance_fused(c, cs.GUMBEL_EPS).item() - d0) / d0
    if checked and (e > cs.TOL_GRAM or e_d > cs.TOL_DIST):
        raise SystemExit(f"coupling: Gram rel err {e}, distance {e_d}")
    fn = lambda: cp.coupling_distance_fused(c, cs.GUMBEL_EPS)  # noqa: E731
    rec.setdefault("events", []).append(
        cs.cuda_ms(torch, fn, iters=cs.TIMING_ITERS))
    rec.setdefault("device", []).append(cs.device_ms(torch, fn))
    n = sum(cs.kernel_launches(torch, fn).values())
    if n != rec.setdefault("kernels a call", n):
        raise SystemExit(f"coupling: {n} kernels a call, then {rec}")
    del c, gram


def gumbel_outputs(torch, cs, rec):
    """#9 and #10 at (5, 5000, 92) and (2, 333, 300), as a training step
    calls them: the seeded soft sample, the hard one on given uniforms,
    dphi and dtemp; each seeded sample against its plain version on the
    numpy twin's uniforms (TOL_GUMBEL), and, bit for bit, the uniforms of
    ``kernel_uniform`` against the twin's and the seeded launch against the
    launch fed the twin's uniforms (recorded)."""
    from dvae_tpu_torch.ops import gumbel as gm
    g = torch.Generator(device="cuda").manual_seed(5)
    outs = []
    for shape in ((A, B, cs.C), (2, 333, 300)):
        phi = cs.categorical_posterior(torch, g, shape)
        u = torch.rand(shape, generator=g, device="cuda")
        dy = torch.randn(shape, generator=g, device="cuda")
        twin = torch.from_numpy(gm.philox_uniform(9, shape)).cuda()
        ys, _ = gm.gumbel_fwd(9, phi, None, 0.7, cs.GUMBEL_EPS)
        y0 = gm.gumbel_softmax_plain(phi, twin, 0.7, cs.GUMBEL_EPS)
        e = cs.rel_err(torch, ys, y0)
        if e > cs.TOL_GUMBEL:
            raise SystemExit(f"gumbel {shape}: rel err {e}")
        key = f"C={shape[-1]}: uniforms, seeded = fed the twin's"
        rec[key] = (bool(torch.equal(gm.kernel_uniform(9, shape, "cuda"),
                                     twin)),
                    bool(torch.equal(ys, gm.gumbel_fwd(
                        9, phi, twin, 0.7, cs.GUMBEL_EPS)[0])))
        yh = gm.gumbel_fwd(3, phi, u, 0.7, cs.GUMBEL_EPS, hard=True)
        # #10 on the plain sample, the same input in every variant
        dphi, dtemp = gm.gumbel_bwd(y0, phi, dy, 0.7, cs.GUMBEL_EPS)
        outs.append((ys, yh[0], yh[1], dphi, dtemp))
    return outs


def gumbel_times(torch, cs, rec):
    """Event and device times of #9 (seeded soft sample, hard sample with
    its soft residual on given uniforms) and #10 at (5, 5000, 92)."""
    from dvae_tpu_torch.ops import gumbel as gm
    g = torch.Generator(device="cuda").manual_seed(5)
    phi = cs.categorical_posterior(torch, g, (A, B, cs.C))
    u = torch.rand(phi.shape, generator=g, device="cuda")
    dy = torch.randn(phi.shape, generator=g, device="cuda")
    y, _ = gm.gumbel_fwd(9, phi, None, 0.7, cs.GUMBEL_EPS)
    for key, fn in (
            ("#9 seeded", lambda: gm.gumbel_fwd(9, phi, None, 0.7,
                                                cs.GUMBEL_EPS)),
            ("#9 hard on u", lambda: gm.gumbel_fwd(3, phi, u, 0.7,
                                                   cs.GUMBEL_EPS, hard=True)),
            ("#10", lambda: gm.gumbel_bwd(y, phi, dy, 0.7, cs.GUMBEL_EPS,
                                          want_dtemp=False))):
        rec.setdefault(f"{key} events", []).append(
            cs.cuda_ms(torch, fn, iters=cs.TIMING_ITERS))
        rec.setdefault(f"{key} device", []).append(cs.device_ms(torch, fn))


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dvae_tpu_torch.ops import encoder as enc
    from dvae_tpu_torch.ops import recon, zinb

    base = None
    if "--base" in argv:
        i = argv.index("--base")
        base = Path(argv[i + 1]).resolve() / "dvae_tpu_torch" / "csrc"
        argv = argv[:i] + argv[i + 2:]
        if not (base / "recon_fwdbwd.cu").exists():
            print(f"no sources in {base}", file=sys.stderr)
            return 2
    names = argv or list(SETS)
    unknown = [n for n in names if n not in SETS]
    if unknown:
        print(f"unknown sets {unknown}; known: {list(SETS)}", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(3)
    x32 = torch.relu(torch.randn((B, D), generator=g, device="cuda"))
    gy32 = torch.randn((A, B, F), generator=g, device="cuda")
    ops32 = cs.zinb_inputs(torch, g, torch.float32, B, False)
    rec32 = {grid: cs.recon_inputs(torch, g, torch.float32, B, False,
                                   on_grid=grid) for grid in (False, True)}
    kink = {dt: cs.recon_clear_of_kink(
        torch, *(t.to(dt) for t in rec32[False][:3]))
        for dt in (torch.float32, torch.bfloat16)}
    out = REPO / "runs" / "kernel_variants"
    for set_name in names:
        kernel, table = SETS[set_name]
        variants = {label: make_variant(out / set_name / f"v{i}", edits)
                    for i, (label, edits) in enumerate(table.items())}
        if base is not None:
            variants[f"the sources of {base.parent.parent}"] = make_variant(
                out / set_name / "base", [], src=base)
        first_out, gumbel_out = {}, {}
        same_bits = {label: True for label in variants}
        print(f"{set_name}: building {len(variants)} variants of {kernel}")
        build_all(variants, LIBRARIES.get(kernel, [kernel]))
        times = {label: {} for label in variants}
        order = list(variants)
        for labels in (order, order[::-1]):
            for label in labels:
                use(variants[label])
                checked = set_name not in TIMING_ONLY or label == order[0]
                for dt in (torch.float32, torch.bfloat16):
                    key = "f32" if dt == torch.float32 else "bf16"
                    rec = times[label]
                    if kernel == "recon_fwd":
                        time_recon_fwd(torch, cs, recon, rec32, dt, key,
                                       rec, checked)
                    elif kernel == "c6":
                        outs = c6_outputs(torch, cs, dt)
                        ref = first_out.setdefault(key, outs)
                        same_bits[label] &= all(
                            bool(torch.equal(u, v)) for u, v in zip(outs, ref))
                        del outs, ref
                        c6_times(torch, cs, rec32, ops32, dt, key, rec)
                    elif kernel == "coupling":
                        if dt == torch.float32:
                            coupling_times(torch, cs, rec, checked)
                    elif kernel == "gumbel":
                        if dt == torch.float32:
                            gumbel_out[label] = gumbel_outputs(torch, cs,
                                                               rec)
                            gumbel_times(torch, cs, rec)
                    elif kernel == "recon_c5":
                        outs = c5_outputs(torch, cs, dt)
                        ref = first_out.setdefault(key, outs)
                        same_bits[label] &= all(
                            bool(torch.equal(u, v)) for u, v in zip(outs, ref))
                        del outs, ref
                        c5_times(torch, cs, rec32, dt, key, rec)
                    elif kernel == "recon_fwdbwd":
                        dname = str(dt)[6:]
                        for grid in (True, False) if checked else ():
                            ops = [t.to(dt) for t in rec32[grid]]
                            got = recon.recon_fwdbwd(*ops)
                            want = recon.recon_fwdbwd_reference(*ops)
                            e_s = ((got[0] - want[0]).abs()
                                   / want[0].abs()).max().item()
                            e_g = max(cs.recon_held_errs(
                                torch, got[2:], want[2:], *kink[dt])
                                if not grid
                                else [cs.rel_err(torch, u, v)
                                      for u, v in zip(got[2:], want[2:])])
                            if (e_s > cs.TOL_SUMSQ[dname]
                                    or e_g > cs.TOL_REL[dname]):
                                raise SystemExit(
                                    f"{label} {key} grid={grid}: sumsq rel "
                                    f"err {e_s}, gradients {e_g}")
                            del got, want, ops
                        ops = [t.to(dt) for t in rec32[False]]
                        if checked:
                            outs = recon.recon_fwdbwd(*ops)
                            ref = first_out.setdefault(key, outs)
                            same_bits[label] &= all(
                                bool(torch.equal(u, v))
                                for u, v in zip(outs, ref))
                            del outs, ref
                        rec.setdefault(key, []).append(cs.cuda_ms(
                            torch, lambda: recon.recon_fwdbwd(*ops)))
                        for name, v in pass_ms(
                                torch, lambda: recon.recon_fwdbwd(*ops)):
                            rec.setdefault(f"{key} {name}", []).append(v)
                        del ops
                    elif kernel == "encoder_fc1":
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
        if kernel == "gumbel" and base is not None:
            # against the kernels of --base: #9 within TOL_GUMBEL, #10 bit
            # for bit (C <= 512)
            ref = gumbel_out[order[-1]]
            for label, outs in gumbel_out.items():
                e9 = max(cs.rel_err(torch, a, b) for o, r in zip(outs, ref)
                         for a, b in zip(o[:3], r[:3]))
                b10 = all(torch.equal(a, b) for o, r in zip(outs, ref)
                          for a, b in zip(o[3:], r[3:]))
                e10 = max(cs.rel_err(torch, a, b) for o, r in zip(outs, ref)
                          for a, b in zip(o[3:], r[3:]))
                times[label]["#9 vs base rel err"] = e9
                times[label]["#10 vs base rel err"] = e10
                times[label]["#10 bit for bit with base at C <= 512"] = b10
                if e9 > cs.TOL_GUMBEL or e10 > cs.TOL_GUMBEL:
                    raise SystemExit(f"{label}: against the base #9 {e9}, "
                                     f"#10 {e10}")
        for label, rec in times.items():
            bits = ""
            if kernel in ("recon_fwdbwd", "recon_c5", "c6") and (
                    set_name not in TIMING_ONLY or label == order[0]):
                bits = (" | outputs bit-identical to the first variant's"
                        + (" (the uniform and the grid draws)"
                           if kernel in ("recon_c5", "c6") else
                           " on the uniform draw") + f": {same_bits[label]}")
            print(f"  {set_name} | {label} | " + " | ".join(
                f"{k} {ts:g}" if isinstance(ts, float) else
                f"{k} {ts}" if not isinstance(ts, list) else
                f"{k} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                for k, ts in rec.items()) + bits)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
