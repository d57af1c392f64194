"""Random sparser, the baseline criterion for ablations (port of
``sparsebit_tpu/sparse/sparsers/random.py``).

Scores are uniform draws from a ``torch.Generator`` seeded 0 on the
weight's device, one stream a sparser, in place of the JAX package's
``jax.random.PRNGKey(0)`` split per call. The two generators differ, so
the port's masks are not the JAX package's: what holds is the fraction
pruned and that two identical runs on one device give the same masks.
"""

import torch

from sparsebit_tpu_torch.sparse.sparsers import register_sparser
from sparsebit_tpu_torch.sparse.sparsers.base import Sparser


@register_sparser
class RandomSparser(Sparser):
    TYPE = "random"

    def __init__(self, config):
        super().__init__(config)
        self._generator = None

    def _scores(self, shape, device):
        if self._generator is None:
            self._generator = torch.Generator(device=device).manual_seed(0)
        return torch.rand(shape, generator=self._generator, device=device)

    def element_scores(self, weight):
        return self._scores(weight.shape, weight.device)

    def channel_scores(self, weight, ch_axis):
        return self._scores((weight.shape[ch_axis],), weight.device)
