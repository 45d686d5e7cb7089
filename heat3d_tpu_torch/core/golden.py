"""NumPy golden reference model — the correctness oracle.

A copy of ``heat3d_tpu.core.golden``: the same fp64 steppers (NumPy, and
the OpenMP one of ``heat3d_tpu_torch.native``) and the same counter-based
initializers, so the port and the JAX package start from byte-equal fields
and hold their results to the same oracle.

Reference parity: BASELINE.json config 1 ("128^3 grid, 7-point Jacobi heat
diffusion, single-rank CPU reference") and SURVEY.md §2 C10. The reference
class validates parallel runs against a serial run; this module is that
serial run, kept deliberately dumb (pad + 27 shifted adds in float64) so it
can be trusted as ground truth for every other path (jnp step, Pallas
kernel, distributed shard_map run).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from heat3d_tpu_torch.core.config import BoundaryCondition, GridConfig, StencilConfig
from heat3d_tpu_torch.core.stencils import STENCILS, nonzero_taps, stencil_taps


def pad_with_ghosts(
    u: np.ndarray, bc: BoundaryCondition, bc_value: float = 0.0
) -> np.ndarray:
    """Return u with a 1-cell ghost layer on every face, filled per the BC."""
    if bc is BoundaryCondition.PERIODIC:
        return np.pad(u, 1, mode="wrap")
    return np.pad(u, 1, mode="constant", constant_values=bc_value)


def step(
    u: np.ndarray,
    taps: np.ndarray,
    bc: BoundaryCondition = BoundaryCondition.DIRICHLET,
    bc_value: float = 0.0,
) -> np.ndarray:
    """One explicit-Euler update of the interior field u (no ghosts in u)."""
    up = pad_with_ghosts(u.astype(np.float64), bc, bc_value)
    nx, ny, nz = u.shape
    out = np.zeros_like(u, dtype=np.float64)
    for (di, dj, dk), w in nonzero_taps(taps):
        out += w * up[1 + di : 1 + di + nx, 1 + dj : 1 + dj + ny, 1 + dk : 1 + dk + nz]
    return out


def run(
    u0: np.ndarray,
    grid: GridConfig,
    stencil: StencilConfig,
    num_steps: int,
    impl: str = "auto",
    taps: Optional[np.ndarray] = None,
) -> np.ndarray:
    """num_steps golden updates; float64 throughout.

    impl: 'numpy' (pure NumPy, always available), 'native' (the OpenMP C++
    stepper in heat3d_tpu_torch.native — the compiled-host-code analogue
    of the reference's serial path, ~100x faster at large grids; raises
    with the compiler's error when it does not build), or 'auto' (native
    when built, else numpy). Both produce identical float64 math;
    tests/test_torch_native.py holds them to tight agreement.

    ``taps`` overrides the derived heat taps — the declarative equation
    families (heat3d_tpu.eqn) pass their spec-compiled taps through here,
    so every family gets the same fp64 oracle (both steppers are
    tap-generic; the stencil arg then only supplies the BC).
    """
    if taps is None:
        taps = stencil_taps(
            STENCILS[stencil.kind],
            grid.alpha,
            grid.effective_dt(),
            grid.spacing,
        )
    if impl not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl in ("auto", "native"):
        from heat3d_tpu_torch import native

        if native.available():
            return native.run(
                u0,
                taps,
                num_steps,
                periodic=stencil.bc is BoundaryCondition.PERIODIC,
                bc_value=stencil.bc_value,
            )
        if impl == "native":
            raise RuntimeError(
                f"native stepper unavailable: {native.build_error()}"
            )
    u = u0.astype(np.float64)
    for _ in range(num_steps):
        u = step(u, taps, stencil.bc, stencil.bc_value)
    return u


def plane_wave(
    shape: Tuple[int, int, int],
    spacing: Tuple[float, float, float],
    wave: Tuple[int, int, int],
    t: float = 0.0,
    mu: float = 0.0,
    omega: float = 0.0,
) -> np.ndarray:
    """The periodic plane-wave manufactured solution, fp64:

        u(x, t) = exp(-mu t) * sin(k . x - omega t)

    with ``k_a = 2*pi*wave_a / (shape_a * spacing_a)`` — integer mode
    numbers, so the wave is exactly periodic on the grid (cell centers at
    ``x_a = i * spacing_a``). Every shipped equation family is linear
    with constant coefficients, so a single plane wave is an EXACT
    continuous solution with family-specific rates ``(mu, omega)``
    (``eqn.mms_rates``) — the MMS oracle for the per-family
    convergence-order tests (tests/test_eqn.py) and the e2e family
    certification on a real device mesh (tests/multidevice_checks.py)."""
    k = [
        2.0 * np.pi * w / (n * h) for w, n, h in zip(wave, shape, spacing)
    ]
    axes = [
        np.arange(n, dtype=np.float64) * h for n, h in zip(shape, spacing)
    ]
    xx, yy, zz = np.meshgrid(*axes, indexing="ij")
    phase = k[0] * xx + k[1] * yy + k[2] * zz - omega * t
    return np.exp(-mu * t) * np.sin(phase)


def wavevector(
    shape: Tuple[int, int, int],
    spacing: Tuple[float, float, float],
    wave: Tuple[int, int, int],
) -> Tuple[float, float, float]:
    """The physical wavevector of integer mode numbers ``wave`` on this
    periodic grid — what :func:`plane_wave` uses and what
    ``eqn.mms_rates`` wants as input (one derivation, shared)."""
    return tuple(
        2.0 * np.pi * w / (n * h) for w, n, h in zip(wave, shape, spacing)
    )


def residual_norm(u_new: np.ndarray, u_old: np.ndarray) -> float:
    """L2 norm of the update difference — the reference's convergence check
    (SURVEY.md §2 C5, §3.3)."""
    d = u_new.astype(np.float64) - u_old.astype(np.float64)
    return float(np.sqrt(np.sum(d * d)))


# Named initial conditions (the reference class's hot plane/point source,
# SURVEY.md §2 C8). make_init_block is the single implementation; make_init,
# gaussian_init, random_init etc. delegate to it so serial, distributed, and
# test paths all see the same field.
INITIALIZERS = ("hot-cube", "gaussian", "random")


def hot_cube_init(shape: Tuple[int, int, int], dtype=np.float32) -> np.ndarray:
    return make_init("hot-cube", shape, dtype=dtype)


def gaussian_init(shape: Tuple[int, int, int], dtype=np.float32) -> np.ndarray:
    return make_init("gaussian", shape, dtype=dtype)


def random_init(
    shape: Tuple[int, int, int], seed: int = 0, dtype=np.float32
) -> np.ndarray:
    return make_init("random", shape, seed=seed, dtype=dtype)


def make_init(
    name: str, shape: Tuple[int, int, int], seed: int = 0, dtype=np.float32
) -> np.ndarray:
    """Full-field named initializer; defined as the all-of-it case of
    :func:`make_init_block` so serial and distributed inits agree exactly."""
    full = tuple(slice(0, n) for n in shape)
    return make_init_block(name, shape, full, seed=seed, dtype=dtype)  # type: ignore[arg-type]


def make_init_block(
    name: str,
    shape: Tuple[int, int, int],
    index: Tuple[slice, slice, slice],
    seed: int = 0,
    dtype=np.float32,
) -> np.ndarray:
    """Evaluate only the ``index`` block of the named global initializer —
    sharding-invariant (block values depend only on global coordinates), so
    a distributed init equals a sliced serial init bit-for-bit and no
    process materializes the full 4096^3 field (SURVEY.md §2 C8).
    """
    starts = [0 if s.start is None else int(s.start) for s in index]
    stops = [n if s.stop is None else int(s.stop) for s, n in zip(index, shape)]
    bshape = tuple(b - a for a, b in zip(starts, stops))

    if name == "hot-cube":
        u = np.zeros(bshape, dtype=dtype)
        sl = []
        for n, a, b in zip(shape, starts, stops):
            g0 = int(n * (0.5 - 0.25 / 2))
            g1 = max(int(n * (0.5 + 0.25 / 2)), g0 + 1)
            sl.append(slice(max(g0 - a, 0), max(min(g1, b) - a, 0)))
        u[tuple(sl)] = 1.0
        return u

    if name == "gaussian":
        axes = [
            np.linspace(-1.0, 1.0, n)[a:b] for n, a, b in zip(shape, starts, stops)
        ]
        xx, yy, zz = np.meshgrid(*axes, indexing="ij")
        r2 = xx**2 + yy**2 + zz**2
        return np.exp(-r2 / (2.0 * 0.15**2)).astype(dtype)

    if name == "random":
        # Counter-based: value is a hash of the global linear index, so it is
        # independent of the decomposition. splitmix64 finalizer -> [0, 1).
        idx = [
            np.arange(a, b, dtype=np.uint64) for a, b in zip(starts, stops)
        ]
        ii, jj, kk = np.meshgrid(*idx, indexing="ij")
        with np.errstate(over="ignore"):  # modular arithmetic is the point
            lin = (ii * np.uint64(shape[1]) + jj) * np.uint64(shape[2]) + kk
            x = lin + np.full_like(lin, 0x9E3779B97F4A7C15) * np.uint64(seed + 1)
            x ^= x >> np.uint64(30)
            x *= np.uint64(0xBF58476D1CE4E5B9)
            x ^= x >> np.uint64(27)
            x *= np.uint64(0x94D049BB133111EB)
            x ^= x >> np.uint64(31)
        return ((x >> np.uint64(11)).astype(np.float64) / float(1 << 53)).astype(
            dtype
        )

    raise ValueError(f"unknown initializer {name!r}; have {sorted(INITIALIZERS)}")
