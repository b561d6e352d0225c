#!/usr/bin/env python3
"""Count the SASS instructions behind the operations bound of the Gumbel
kernels (#9, #10) and the coupling kernel (#11) on one NVIDIA GPU's
toolkit.

    python3 scripts/gumbel_sass.py

Compiles probe kernels with the port's nvcc flags (one accurate logf, one
expf, one IEEE division, one Philox4x32-10 draw of ``csrc/philox.cuh`` an
element, and an empty copy as the baseline), disassembles them with
``cuobjdump -sass`` and prints each probe's instructions beyond the
baseline's, by opcode: the counts that ``chip_smoke.py`` keeps as OPS_LOG,
OPS_EXP, OPS_DIV, OPS_PHILOX and PHILOX_MULS.  The counts are static:
each instruction once, over the whole probe and over its main path (up to
its last EXIT; a slow path the compiler made a subroutine, such as the
division's, lies beyond it).
Then it disassembles the built ``gumbel`` library and prints, for the
forward kernel the production shape runs (``gumbel_fwd_rows`` with 3 quads
a lane, soft, Philox), its instructions by opcode and per element.
The probe sources go to ``runs/gumbel_sass/`` (not committed).  Exits 2
without nvcc or cuobjdump.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PROBES = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "philox.cuh"

extern "C" __global__ void probe_base(const float* x, const float* y,
                                      float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i];
}
extern "C" __global__ void probe_log(const float* x, const float* y,
                                     float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = logf(x[i]);
}
extern "C" __global__ void probe_exp(const float* x, const float* y,
                                     float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = expf(x[i]);
}
extern "C" __global__ void probe_div(const float* x, const float* y,
                                     float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] / y[i];
}
extern "C" __global__ void probe_philox(const float* x, const float* y,
                                        float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const uint4 r = philox4x32_10(make_uint4(i, n, 0u, 0u),
                                  __float_as_uint(x[0]), 0x5EED0002u);
    out[i] = __uint_as_float(r.x ^ r.y ^ r.z ^ r.w);
  }
}
"""

INT_MULS = re.compile(r"^(IMAD\.WIDE|IMAD\.HI|IMUL)")


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", name)
    return path if os.path.exists(path) else ""


def sass_functions(lib: Path) -> dict:
    """{function name: [opcode, ...]} of a shared library's SASS."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and name is not None and m.group(1) != "NOP":
            funcs[name].append(m.group(1))
    return funcs


def main_path(ops: list) -> list:
    """The instructions up to the function's last EXIT."""
    last = max((i for i, op in enumerate(ops) if op == "EXIT"), default=-1)
    return ops[:last + 1]


def main() -> int:
    from dvae_tpu_torch.ops import _build
    if not tool("nvcc") or not tool("cuobjdump"):
        print("nvcc or cuobjdump not found", file=sys.stderr)
        return 2
    out = REPO / "runs" / "gumbel_sass"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "probes.cu"
    src.write_text(PROBES)
    lib = out / "libprobes.so"
    subprocess.run([tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    funcs = sass_functions(lib)
    base = collections.Counter(funcs["probe_base"])
    base_main = collections.Counter(main_path(funcs["probe_base"]))
    print(f"baseline probe: {sum(base.values())} instructions, "
          f"{sum(base_main.values())} on its main path")
    for name in ("log", "exp", "div", "philox"):
        ops = funcs[f"probe_{name}"]
        extra = collections.Counter(ops) - base
        main = collections.Counter(main_path(ops)) - base_main
        muls = sum(n for op, n in main.items() if INT_MULS.match(op))
        print(f"{name}: {sum(extra.values())} instructions beyond the "
              f"baseline's, {sum(main.values())} on the main path ({muls} "
              "integer multiplies): "
              + ", ".join(f"{op} {n}" for op, n in main.most_common()))
    _build.build(("gumbel",))
    gfuncs = sass_functions(_build.library_path("gumbel"))
    for name, ops in sorted(gfuncs.items()):
        if "gumbel_fwd_rows" in name and "ILi3ELb0ELb1E" in name:
            count = collections.Counter(ops)
            muls = sum(n for op, n in count.items() if INT_MULS.match(op))
            print(f"{name}: {len(ops)} instructions ({muls} integer "
                  f"multiplies), {len(ops) / 12:.1f} an element of the "
                  "lane's 12 (static, the prefetch and shuffle loops "
                  "once): " + ", ".join(f"{op} {n}" for op, n in
                                         count.most_common()))
    for name, ops in sorted(gfuncs.items()):
        print(f"  {len(ops):6d} {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
