"""The randomness of the program's epoch runner with a frozen augmenter,
worked out again from the same seeds.

With an augmenter the program's train step (``train/step.make_train_step``)
makes the step's per-arm views before anything else, from the chunk's
``torch.Generator``: the augmenter's noise z (A, B, noise_dim) and then
its reparameterisation noise e (A, B, latent_dim), both standard normal
(``augment/augmenter.augment_arms``).  The model's own draws follow in the
order ``draws.RunnerDraws`` gives; the host's encoder seed is drawn from
the numpy generator as there.
"""

from __future__ import annotations

import torch

from portbench.reference.draws import RunnerDraws


class AugRunnerDraws(RunnerDraws):
    """The draws of one call of the augmented epoch runner that starts at
    ``epoch``; ``m`` is the configuration's ``model`` group, which holds
    the ``augmenter`` group."""

    def step_noise(self) -> dict:
        a, g, dev = self.m["augmenter"], self.gen, self.device
        A, B = self.m["n_arm"], self.batch
        z = torch.randn((A, B, a["noise_dim"]), generator=g, device=dev)
        e = torch.randn((A, B, a["latent_dim"]), generator=g, device=dev)
        noise = super().step_noise()
        noise.update(aug_z=z, aug_e=e)
        return noise
