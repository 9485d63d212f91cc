"""Minimal distribution library for the DMPO stack (PyTorch).

Only what DMPO needs: sampling, log-probabilities and the per-dimension KL
of diagonal Gaussians, and the mean of a categorical over a fixed support
(the distributional critic's head).
"""

from __future__ import annotations

import dataclasses
import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class NormalDiag:
    """Diagonal Gaussian over action vectors; batch dims lead."""
    mean: torch.Tensor    # (..., d)
    stddev: torch.Tensor  # (..., d)

    def transform(self, eps: torch.Tensor) -> torch.Tensor:
        """mean + stddev * eps for standard normals ``eps`` of shape
        sample_shape + mean.shape."""
        return self.mean + self.stddev * eps

    def sample(self, generator: torch.Generator | None = None,
               sample_shape=()) -> torch.Tensor:
        # frozen copy: drawn in float32 and cast (see dmpo.losses)
        eps = torch.randn(tuple(sample_shape) + tuple(self.mean.shape),
                          generator=generator, dtype=torch.float32,
                          device=self.mean.device).to(self.mean.dtype)
        return self.transform(eps)

    def log_prob_per_dim(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.mean) / self.stddev
        return -0.5 * z * z - torch.log(self.stddev) - _HALF_LOG_2PI

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.log_prob_per_dim(x), dim=-1)

    def entropy(self) -> torch.Tensor:
        return torch.sum(torch.log(self.stddev) + _HALF_LOG_2PI + 0.5,
                         dim=-1)

    def mode(self) -> torch.Tensor:
        return self.mean


def kl_normal_diag_per_dim(p: NormalDiag, q: NormalDiag) -> torch.Tensor:
    """KL(p || q) per action dimension (decoupled-KL MPO needs per-dim)."""
    var_ratio = (p.stddev / q.stddev) ** 2
    mean_term = ((q.mean - p.mean) / q.stddev) ** 2
    return 0.5 * (var_ratio + mean_term - 1.0 - torch.log(var_ratio))


@dataclasses.dataclass(frozen=True)
class DiscreteValued:
    """Categorical over a fixed support (distributional critic head)."""
    logits: torch.Tensor  # (..., n_atoms)
    values: torch.Tensor  # (n_atoms,)

    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def mean(self) -> torch.Tensor:
        return torch.sum(self.probs() * self.values, dim=-1)
