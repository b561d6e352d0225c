"""Which ``torch.distributed`` collectives the gloo backend takes on CUDA
tensors, with two ranks on one card.

The port builds its collective layer (``dvae_tpu_torch/parallel/
runtime.py``) from the collectives that pass here, on every backend, so
that two ranks on one card over gloo run the code that NCCL runs on
several cards.  Run it on a machine with a card:

    python3 scripts/gloo_cuda_probe.py

It prints the card's name and power limit, the torch and CUDA versions,
and one JSON line: for each collective and dtype, "ok" or the error's
first line, for CUDA tensors and for CPU tensors.  Each rank runs under a
60 s limit and is killed after it.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

DTYPES = ("float32", "bfloat16", "int64", "int32", "uint8")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    out = {}
    for dev in ("cuda", "cpu"):
        for name in DTYPES:
            dt = getattr(torch, name)

            def t(n=4):
                return (torch.arange(n, device=dev) + 1 + rank).to(dt)
            cases = {
                "all_reduce": lambda: dist.all_reduce(t()),
                "broadcast": lambda: dist.broadcast(t(), src=0),
                "all_gather": lambda: dist.all_gather([t(), t()], t()),
                "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                    t(8), t()),
                "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                    t(), t(8)),
            }
            for cname, fn in cases.items():
                key = f"{cname}/{dev}/{name}"
                try:
                    fn()
                    if dev == "cuda":
                        torch.cuda.synchronize()
                    out[key] = "ok"
                except Exception as e:  # the finding is the refusal itself
                    out[key] = str(e).splitlines()[0][:160]
                dist.barrier()
    if rank == 0:
        print(json.dumps(out, sort_keys=True))
    dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) == 3:
        _rank(int(sys.argv[1]), int(sys.argv[2]))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), str(port)]) for r in range(2)]
    rc = 0
    for p in procs:
        try:
            rc |= p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            rc = 1
    for p in procs:
        if p.poll() is None:
            p.kill()
    return rc


if __name__ == "__main__":
    sys.exit(main())
