"""Builder and loader of the port's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` exposes a plain C interface; the
headers ``csrc/*.cuh`` hold device code that several sources share.  A
source is compiled at first use with ``nvcc`` for Hopper (``sm_90a``) into
a shared library under ``csrc/build/`` (listed in ``.gitignore``), or
under the directory that the environment variable ``DVAE_TORCH_BUILD_DIR``
names (for an installation whose package directory is read-only), named by
a hash of the source, the shared headers and the flags, and loaded with
``ctypes``.  No PyTorch header is compiled: a build takes seconds, not
minutes.

``build`` starts one ``nvcc`` per missing library, all at once, and waits
for all of them.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"   # the default build directory
BUILD_DIR_ENV = "DVAE_TORCH_BUILD_DIR"
KERNELS = ("recon_fwd", "recon_fwdbwd", "encoder_fc1", "zinb_fwd",
           "zinb_fwdbwd", "gumbel", "coupling", "decoder", "augment_fc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels build on a machine with the "
                           "CUDA toolkit")
    return path


def build_dir() -> Path:
    """Where the libraries are built: ``$DVAE_TORCH_BUILD_DIR`` if set and
    not empty, else ``csrc/build/``."""
    env = os.environ.get(BUILD_DIR_ENV)
    return Path(env).expanduser() if env else BUILD_DIR


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict:
    """Compile every library of ``names`` that is not built yet, in
    parallel.  Returns {name: compiler output} for what was compiled;
    raises with the compiler's output if any build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
