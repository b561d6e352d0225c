"""The randomness of the program's training and eval calls, worked out
again from the same seeds.

The program's epoch runner (``dvae_tpu_torch/train/step.py``:
``chunk_rngs``, ``make_epoch_runner``) seeds one numpy generator with
(state seed, epoch) at the start of a call; its first draw seeds a
``torch.Generator`` on the data's device.  Each epoch draws a permutation
of the rows from the torch generator; each step then draws, in this order:

  * from numpy, the seed of the fused encoder kernel's dropout mask (on
    the card the kernel turns it into the mask, ``philox.keep_mask``; on
    the CPU the mask is drawn instead from the torch generator, as a
    uniform (A, B, D) tensor, before anything else of the step);
  * from torch, the Gumbel uniforms (A, B, C), the reparameterisation
    noise (A, B, S, normal) and state dropout's uniforms (A, B, S).

Eval draws its (A, rows, S) normal noise for every batch from a CPU
``torch.Generator`` seeded with the state seed.  These are the inputs both
sides get: the reference draws them itself, with the same calls.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import philox


class RunnerDraws:
    """The draws of one call of the epoch runner that starts at ``epoch``."""

    def __init__(self, seed: int, epoch: int, device, n_train: int,
                 batch: int, m: dict):
        self.host = np.random.default_rng([int(seed), int(epoch)])
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(self.host.integers(0, 2 ** 63 - 1)))
        self.device = torch.device(device)
        self.n_train, self.batch, self.m = n_train, batch, m

    def epoch_plan(self) -> torch.Tensor:
        """(steps, B) row indices of one epoch; the last partial batch is
        dropped."""
        steps = self.n_train // self.batch
        perm = torch.randperm(self.n_train, generator=self.gen,
                              device=self.device)
        return perm[: steps * self.batch].reshape(steps, self.batch)

    def step_noise(self) -> dict:
        m, g, dev = self.m, self.gen, self.device
        A, B, D = m["n_arm"], self.batch, m["input_dim"]
        C, S = m["n_categories"], m["state_dim"]
        enc_seed = int(self.host.integers(0, 2 ** 31 - 1))
        if dev.type == "cuda":
            x_keep = philox.keep_mask(enc_seed, (A, B, D), m["x_drop"], dev)
        else:
            x_keep = torch.rand((A, B, D), generator=g, device=dev) < (
                1.0 - m["x_drop"])
        u = torch.rand((A, B, C), generator=g, device=dev)
        e = torch.randn((A, B, S), generator=g, device=dev)
        s_keep = torch.rand((A, B, S), generator=g, device=dev) < (
            1.0 - m["s_drop"])
        return {"x_keep": x_keep, "u": u, "e": e, "s_keep": s_keep}


def eval_noise(seed: int, m: dict, device):
    """noise_fn(rows) → the (A, rows, S) noise of one eval batch."""
    def fn(rows: int) -> torch.Tensor:
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        e = torch.randn((m["n_arm"], rows, m["state_dim"]), generator=gen,
                        device="cpu", dtype=torch.float32)
        return e.to(device)
    return fn
