"""The plain reference: explicit-Euler heat updates in plain PyTorch.

It works the update out again from the configuration file alone: the
Laplacian weights of the stencil (frozen here), the spacing, ``alpha`` and
``dt`` give the 3x3x3 update taps ``T = I + dt*alpha*W/h^2``; the domain
faces see ghost cells held at ``bc_value`` (Dirichlet). One update is the
sum of each nonzero tap times the shifted field, one whole-field operation
a tap, in the dtype asked for (``float32`` as the configurations state it;
``float64`` in the tests). It imports nothing of the program.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Laplacian weights at unit spacing, [di+1, dj+1, dk+1] multiplies
# u[i+di, j+dj, k+dk]. 27pt: the isotropic compact stencil, weight by the
# number of nonzero offsets: centre -64/15, faces 7/15, edges 1/10,
# corners 1/30.
_BY_DISTANCE = {
    "7pt": {0: -6.0, 1: 1.0, 2: 0.0, 3: 0.0},
    "27pt": {0: -64.0 / 15.0, 1: 7.0 / 15.0, 2: 1.0 / 10.0, 3: 1.0 / 30.0},
}
# slab of x-planes in which the residual and the gaps are summed
SLAB = 64


def laplacian(kind: str) -> np.ndarray:
    w = np.empty((3, 3, 3))
    for i in range(3):
        for j in range(3):
            for k in range(3):
                w[i, j, k] = _BY_DISTANCE[kind][abs(i - 1) + abs(j - 1) + abs(k - 1)]
    return w


def stable_dt(config: dict) -> float:
    """Forward-Euler bound of the diffusion operator, 1 / (2 alpha sum 1/h^2)."""
    return 1.0 / (2.0 * config["alpha"] * sum(1.0 / h**2 for h in config["spacing"]))


def taps(config: dict) -> np.ndarray:
    """The update taps of ``config`` (float64)."""
    kind, (hx, hy, hz) = config["stencil"], config["spacing"]
    if config["bc"] != "dirichlet":
        raise ValueError(f"the reference holds Dirichlet faces only, got {config['bc']!r}")
    if config["dt"] > stable_dt(config):
        raise ValueError(f"dt {config['dt']} above the stable step {stable_dt(config)}")
    w = laplacian(kind)
    if kind == "7pt":
        lap = np.zeros((3, 3, 3))
        for axis, h in enumerate((hx, hy, hz)):
            for side in (0, 2):
                idx = [1, 1, 1]
                idx[axis] = side
                lap[tuple(idx)] = w[tuple(idx)] / h**2
        lap[1, 1, 1] = -lap.sum()
    else:
        if not hx == hy == hz:
            raise ValueError(f"{kind} needs uniform spacing, got {config['spacing']}")
        lap = w / hx**2
    t = config["dt"] * config["alpha"] * lap
    t[1, 1, 1] += 1.0
    return t


class Reference:
    """Updates of a field of the configuration's grid on ``device`` in
    ``dtype``, between two ghost-padded buffers of its own."""

    def __init__(self, config: dict, device, dtype: torch.dtype = torch.float32,
                 shape: Optional[Tuple[int, int, int]] = None):
        self.taps = [((i, j, k), float(w)) for (i, j, k), w in np.ndenumerate(taps(config))
                     if w != 0.0]
        self.shape = tuple(shape or config["grid"])
        self.dtype = dtype
        padded = tuple(n + 2 for n in self.shape)
        bc = float(config["bc_value"])
        self._bufs = [torch.full(padded, bc, dtype=dtype, device=device) for _ in range(2)]

    def _interior(self, buf: torch.Tensor) -> torch.Tensor:
        nx, ny, nz = self.shape
        return buf[1:nx + 1, 1:ny + 1, 1:nz + 1]

    def _update(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        nx, ny, nz = self.shape
        out = self._interior(dst)
        first = True
        for (i, j, k), w in self.taps:
            view = src[i:i + nx, j:j + ny, k:k + nz]
            if first:
                torch.mul(view, w, out=out)
                first = False
            else:
                out.add_(view, alpha=w)

    def run(self, u: torch.Tensor, steps: int,
            residual_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, Optional[float]]:
        """``steps`` updates of ``u`` (not changed); the field after them
        (a view of a buffer of the reference's: copy it before the next
        call) and, with ``residual_dtype``, the L2 norm of the last
        update's change summed in that dtype."""
        src, dst = self._bufs
        self._interior(src).copy_(u)
        for _ in range(steps):
            self._update(src, dst)
            src, dst = dst, src
        residual = None
        if residual_dtype is not None and steps > 0:
            new, old = self._interior(src), self._interior(dst)
            total = torch.zeros((), dtype=residual_dtype, device=new.device)
            for x in range(0, self.shape[0], SLAB):
                d = new[x:x + SLAB].to(residual_dtype) - old[x:x + SLAB].to(residual_dtype)
                total += torch.sum(d * d, dtype=residual_dtype)
            residual = float(torch.sqrt(total))
        return self._interior(src), residual


def max_gap(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """(largest |got - want|, largest |want|) over the field, in float64,
    summed slab by slab."""
    gap, scale = 0.0, 0.0
    for x in range(0, want.shape[0], SLAB):
        w = want[x:x + SLAB].double()
        gap = max(gap, float((got[x:x + SLAB].double() - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    return gap, scale


def l2(t: torch.Tensor) -> float:
    """The L2 norm of a field in float64, summed slab by slab."""
    total = 0.0
    for x in range(0, t.shape[0], SLAB):
        total += float(torch.sum(t[x:x + SLAB].double() ** 2))
    return total ** 0.5


def faces(t: torch.Tensor):
    """The six boundary faces of a field, the cells next to the ghosts."""
    return (t[0], t[-1], t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1])


def face_gap(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """(largest |got - want|, largest |want|) over the six faces."""
    gap, scale = 0.0, 0.0
    for g, w in zip(faces(got), faces(want)):
        w = w.double()
        gap = max(gap, float((g.double() - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    return gap, scale
