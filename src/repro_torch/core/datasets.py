"""Synthetic datasets from the paper §4, on a ``torch.Generator``.

They have the distributions of the JAX package's ``core/datasets.py`` but
not its numbers (threefry cannot be reproduced): tests that compare the two
packages make their corpus with one of them and pass it as numpy.

  * gaussian: covariance 2*I_d; the non-single variant centers one
    Gaussian on each canonical basis vector.
  * clustered: c Gaussian clusters, means ``sep`` apart, unit covariance,
    shuffled so input order reveals nothing.
  * mnist_like: 70'000 x 784 with 10 clusters, values in [0, 1] — the
    stand-in for MNIST, which cannot be downloaded here.
"""
from __future__ import annotations

import math

import torch


def _gen(generator, seed: int, device) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


def gaussian(n: int, d: int, *, single: bool = True, generator=None,
             seed: int = 0, device="cpu") -> torch.Tensor:
    g = _gen(generator, seed, device)
    noise = math.sqrt(2.0) * torch.randn(n, d, generator=g, device=device)
    if single:
        return noise
    which = torch.randint(0, d, (n,), generator=g, device=device)
    return torch.eye(d, device=device)[which] + noise


def clustered(n: int, d: int, c: int, *, sep: float = 12.0,
              labels: bool = False, generator=None, seed: int = 0,
              device="cpu"):
    g = _gen(generator, seed, device)
    means = sep * torch.randn(c, d, generator=g, device=device)
    which = torch.randint(0, c, (n,), generator=g, device=device)
    x = means[which] + torch.randn(n, d, generator=g, device=device)
    perm = torch.randperm(n, generator=g, device=device)
    if labels:
        return x[perm], which[perm]
    return x[perm]


def mnist_like(n: int = 70_000, d: int = 784, *, generator=None,
               seed: int = 0, device="cpu") -> torch.Tensor:
    x, _ = clustered(n, d, 10, sep=4.0, labels=True, generator=generator,
                     seed=seed, device=device)
    return (x.abs() * 0.25).clamp(0.0, 1.0)
