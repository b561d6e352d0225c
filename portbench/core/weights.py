"""Weights and batch-norm statistics made by the benchmark from a seed.

Both sides get the same numbers: the program's state is overwritten with
them, and the reference starts from them.  Weights follow ``nn.Linear``'s
default, W, b ~ U(−1/√fan_in, 1/√fan_in), drawn on the device with one
``torch.Generator`` in one call for all leaves.
"""

from __future__ import annotations

import torch

from portbench.reference.model import layer_shapes

BN_DIMS = ("bn1", "bn2", "bn3", "bn4", "bn5")


def _leaves(m: dict):
    A = m["n_arm"]
    for name, (fan_in, fan_out) in sorted(layer_shapes(m).items()):
        yield name, "b", (A, fan_out), fan_in
        yield name, "w", (A, fan_in, fan_out), fan_in


def make_params(m: dict, seed: int, device) -> dict:
    leaves = list(_leaves(m))
    total = sum(torch.Size(s).numel() for *_, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    u = torch.rand(total, generator=gen, device=device)
    params, at = {}, 0
    for name, leaf, shape, fan_in in leaves:
        n = torch.Size(shape).numel()
        bound = 1.0 / fan_in ** 0.5
        params.setdefault(name, {})[leaf] = (
            (2.0 * u[at:at + n] - 1.0) * bound).reshape(shape)
        at += n
    return params


def make_bn(m: dict, seed: int, device) -> dict:
    """Running statistics as a trained model has them: means in [0, 1),
    variances in [0.5, 1.5)."""
    A, Fd, L = m["n_arm"], m["fc_dim"], m["lowD_dim"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    out = {}
    for name in BN_DIMS:
        d = L if name == "bn5" else Fd
        u = torch.rand((2, A, d), generator=gen, device=device)
        out[name] = {"mean": u[0].clone(), "var": 0.5 + u[1]}
    return out


def load_into(dst: dict, src: dict) -> None:
    """Copy a tree of tensors into the program's tree of the same shape,
    in place; a missing leaf or another shape is an error."""
    for name, layer in src.items():
        for leaf, t in layer.items():
            have = dst[name][leaf]
            if have.shape != t.shape:
                raise ValueError(f"{name}.{leaf}: the program holds "
                                 f"{tuple(have.shape)}, the benchmark made "
                                 f"{tuple(t.shape)}")
            with torch.no_grad():
                have.copy_(t)
