"""The inputs of a run, made from its seed: the initial field and the
chunk of the window whose answers are checked.

The field is a few Gaussian blobs over uniform noise, made on the device
with a ``torch.Generator`` in a few whole-field calls (no host copy of the
grid). The same seed on the same device gives the same field, so the
reference makes it again rather than taking the program's copy. Every
seed gives the same sizes and the same amount of work; only the values
and the checked chunk differ.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

BLOBS = 6
NOISE = 0.05  # half-width of the uniform noise, every cell and face included
AMPLITUDE = (0.5, 1.0)
WIDTH = (0.03, 0.10)  # sigma, as a share of the axis
CENTER = (0.2, 0.8)  # as a share of the axis


def _seed(seed: int) -> int:
    return int(seed) % 2**63


def blobs(seed: int, shape: Sequence[int]) -> List[Tuple[float, Tuple[float, ...], Tuple[float, ...]]]:
    """(amplitude, centre, sigma) of each blob, in cells."""
    rng = np.random.default_rng([_seed(seed), 0])
    out = []
    for _ in range(BLOBS):
        amp = float(rng.uniform(*AMPLITUDE))
        centre = tuple(float(rng.uniform(*CENTER) * n) for n in shape)
        sigma = tuple(float(rng.uniform(*WIDTH) * n) for n in shape)
        out.append((amp, centre, sigma))
    return out


def check_chunk(seed: int, most: int) -> int:
    """The window chunk (1-based, 1..``most``) whose answers are checked."""
    return 1 + int(np.random.default_rng([_seed(seed), 1]).integers(most))


def initial_field(seed: int, shape: Sequence[int], device, dtype=torch.float32) -> torch.Tensor:
    shape = tuple(int(n) for n in shape)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u.mul_(2 * NOISE).sub_(NOISE)
    for amp, centre, sigma in blobs(seed, shape):
        g = [torch.exp(-0.5 * ((torch.arange(n, device=device, dtype=torch.float32) - c) / s) ** 2)
             for n, c, s in zip(shape, centre, sigma)]
        u.addcmul_((amp * g[0])[:, None, None], (g[1][:, None] * g[2][None, :])[None])
    return u if dtype == torch.float32 else u.to(dtype)
