"""Stencil definitions: 3x3x3 tap sets for the finite-difference operators.

The reference implements one hard-coded CUDA 7-point Jacobi kernel
(SURVEY.md §2 C1: ``u_new = c0*u + c1*(6 neighbors)``). Here a stencil is
data — a 3x3x3 array of Laplacian weights (units 1/h^2 factored out per
axis) — so the golden model, the jnp step, and the Pallas kernel all consume
one definition, and the judged 27-point stencil (BASELINE.json config 4) is
a second entry in the same table rather than a second kernel family.

The time-update taps are ``T = I + dt*alpha*W`` where W is the Laplacian
tap array scaled by the grid spacing; see :func:`stencil_taps`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Stencil:
    """A 3x3x3 Laplacian stencil.

    ``weights[di+1, dj+1, dk+1]`` multiplies ``u[i+di, j+dj, k+dk]``.
    Weights are for unit spacing; :func:`stencil_taps` applies spacing.
    For the 7-point stencil the anisotropic-spacing scaling is exact
    (axis-separable); for the 27-point stencil uniform spacing is assumed
    (validated at tap construction).
    """

    name: str
    weights: np.ndarray  # (3,3,3) float64
    order: int  # formal accuracy order
    separable: bool  # True if exact under anisotropic spacing

    def __post_init__(self):
        w = np.asarray(self.weights, dtype=np.float64)
        if w.shape != (3, 3, 3):
            raise ValueError(f"stencil weights must be (3,3,3), got {w.shape}")
        object.__setattr__(self, "weights", w)
        if abs(w.sum()) > 1e-12:
            raise ValueError(f"Laplacian taps must sum to 0, got {w.sum()}")

    @property
    def num_taps(self) -> int:
        return int(np.count_nonzero(self.weights))


def _seven_point() -> Stencil:
    w = np.zeros((3, 3, 3))
    w[1, 1, 1] = -6.0
    w[0, 1, 1] = w[2, 1, 1] = 1.0
    w[1, 0, 1] = w[1, 2, 1] = 1.0
    w[1, 1, 0] = w[1, 1, 2] = 1.0
    return Stencil(name="7pt", weights=w, order=2, separable=True)


def _twenty_seven_point() -> Stencil:
    """Isotropic 27-point Laplacian: center -64/15, faces 7/15, edges 1/10,
    corners 1/30 (all / h^2). O(h^2) like the 7-point but with isotropic
    leading error — the standard 'higher-order' compact 3D stencil
    (BASELINE.json config 4)."""
    w = np.empty((3, 3, 3))
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                manhattan = abs(di) + abs(dj) + abs(dk)
                w[di + 1, dj + 1, dk + 1] = {
                    0: -64.0 / 15.0,
                    1: 7.0 / 15.0,
                    2: 1.0 / 10.0,
                    3: 1.0 / 30.0,
                }[manhattan]
    return Stencil(name="27pt", weights=w, order=2, separable=False)


STENCILS: Dict[str, Stencil] = {s.name: s for s in (_seven_point(), _twenty_seven_point())}


def scaled_laplacian(
    weights: np.ndarray,
    spacing: Tuple[float, float, float],
    separable: bool,
    name: str = "stencil",
) -> np.ndarray:
    """Scale 3x3x3 Laplacian-like weights by the grid spacing: the
    spatial-operator half of :func:`stencil_taps`, factored out so the
    declarative equation compiler (heat3d_tpu.eqn) lowers its diffusion
    terms through the EXACT float arithmetic the legacy path runs (the
    spec-vs-hardcoded bitwise contract rides on this body being shared).

    Separable weights get per-axis 1/h_axis^2 on the axis taps with the
    center rebalanced to keep rows summing to the same Laplacian;
    non-separable weights require uniform spacing."""
    hx, hy, hz = spacing
    w = weights
    if separable:
        scale = np.zeros((3, 3, 3))
        # axis taps live where exactly one index differs from center
        scale[0, 1, 1] = scale[2, 1, 1] = 1.0 / hx**2
        scale[1, 0, 1] = scale[1, 2, 1] = 1.0 / hy**2
        scale[1, 1, 0] = scale[1, 1, 2] = 1.0 / hz**2
        # center balances so rows still sum to the same Laplacian
        lap = w * scale
        lap[1, 1, 1] = -(lap.sum() - lap[1, 1, 1])
    else:
        if not (hx == hy == hz):
            raise ValueError(
                f"stencil {name!r} requires uniform spacing, got {spacing}"
            )
        lap = w / hx**2
    return lap


def stencil_taps(
    stencil: Stencil,
    alpha: float,
    dt: float,
    spacing: Tuple[float, float, float],
) -> np.ndarray:
    """Build the 3x3x3 *update* taps T such that one explicit-Euler step is
    ``u_new[c] = sum_{d in 3x3x3} T[d] * u[c+d-1]``.

    T = I + dt*alpha*W/h^2. For the separable 7-point stencil each axis pair
    is scaled by its own 1/h_axis^2 (matching the reference's anisotropic
    c1x/c1y/c1z coefficients, SURVEY.md §2 C1); non-separable stencils
    require uniform spacing.
    """
    lap = scaled_laplacian(
        stencil.weights, spacing, stencil.separable, name=stencil.name
    )
    taps = dt * alpha * lap
    taps[1, 1, 1] += 1.0
    return taps


def nonzero_taps(taps: np.ndarray):
    """Yield ((di,dj,dk), weight) for nonzero entries, offsets in {-1,0,1}.

    Iteration order is deterministic (lexicographic) so compiled programs
    are reproducible.
    """
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                v = float(taps[di + 1, dj + 1, dk + 1])
                if v != 0.0:
                    yield (di, dj, dk), v


def flat_taps(taps: np.ndarray):
    """The canonical flattened tap tuple ``((di, dj, dk, w), ...)`` in
    nonzero_taps order — the element order is load-bearing: it defines the
    accumulation order contract of :func:`accumulate_taps` and the list
    equality inside :func:`split_x_symmetric`. All backends must flatten
    through here."""
    return tuple((di, dj, dk, w) for (di, dj, dk), w in nonzero_taps(taps))


def split_x_symmetric(taps_flat):
    """Factor an x-symmetric tap set: return (A, B) where A is the common
    (dj, dk, w) pattern of the di = ±1 planes and B the di = 0 pattern, or
    None when the set is not x-symmetric or too small to profit.

    Both judged stencils are x-symmetric, so
    ``A⊗u[x-1] + A⊗u[x+1] == A⊗(u[x-1] + u[x+1])`` — one plane add replaces
    a whole second 2D tap pass, cutting the 27-point chain from 27
    slice-FMAs to 9 + 9 + 1 (measured +19–43% on chip). For the 7-point set
    the flop saving is nil (A is a single tap), so by default the original
    chain — which carries the measured headline numbers — is kept; setting
    ``HEAT3D_FACTOR_7PT=1`` factors it anyway (fewer shifted slice reads —
    an on-chip A/B knob, see the gate below)."""
    import os

    by_di = {-1: [], 0: [], 1: []}
    for di, dj, dk, w in taps_flat:
        by_di[di].append((dj, dk, w))
    # HEAT3D_FACTOR_7PT=1 extends the factoring to the 7-point set: the
    # saving there is not flops (1 add + 7 FMA vs 7 FMA) but SHIFTS — the
    # ±x taps become one unshifted FMA on the plane sum, trading two
    # lane/sublane-rotated slice reads for an unshifted add. A/B knob for
    # on-chip measurement; off by default (and for "", "0", "false") so
    # the measured headline's op order is exactly the committed record's.
    factor_7pt = os.environ.get("HEAT3D_FACTOR_7PT", "").lower() not in (
        "", "0", "false",
    )
    min_taps = 1 if factor_7pt else 8
    if len(taps_flat) < min_taps or by_di[-1] != by_di[1] or not by_di[-1]:
        return None
    return by_di[-1], by_di[0]


def split_y_symmetric(plane_taps):
    """Factor a y-symmetric 2D plane pattern: given ``[(dj, dk, w), ...]``,
    return (R, M) where R is the common (dk, w) row pattern of the dj = ±1
    rows and M the dj = 0 row, or None when the pattern is not y-symmetric.

    Second reflection symmetry of the isotropic stencils (the 27-point set
    is symmetric in all three axes): within a plane,
    ``R⊗row[y-1] + R⊗row[y+1] == R⊗(row[y-1] + row[y+1])`` — one row add
    replaces a whole second 1D tap pass. Applied to both factored chains
    of the 27-point stencil this cuts 9+9 plane ops to (3+3)+(3+3) plus
    two row adds (19 -> 15 ops total, and fewer sublane-shifted reads)."""
    by_dj = {-1: [], 0: [], 1: []}
    for dj, dk, w in plane_taps:
        by_dj[dj].append((dk, w))
    if not by_dj[-1] or by_dj[-1] != by_dj[1]:
        return None
    return by_dj[-1], by_dj[0]


def _factor_y_enabled() -> bool:
    """HEAT3D_FACTOR_Y knob (default on; '0'/'false' disable) — ONE parser,
    shared by the emission (accumulate_taps) and the VMEM estimate
    (effective_num_taps) so the two can never desynchronize."""
    import os

    return os.environ.get("HEAT3D_FACTOR_Y", "1").lower() not in ("0", "false")


class _CountToken:
    """Absorbing element for the counting pass of effective_num_taps."""

    def __add__(self, other):
        return self

    __radd__ = __add__

    def __mul__(self, other):
        return self

    __rmul__ = __mul__


def effective_num_taps(taps: np.ndarray) -> int:
    """Live-temporary count of the chain :func:`accumulate_taps` actually
    emits under the current factoring knobs: emitted terms plus the cached
    plane/row sums. The VMEM scoped-stack estimators
    (ops.stencil_pallas._tap_stack_bytes and the direct kernels' chunk
    pickers) size the tap chain with this, so the factored 27-point chain
    (~15 live planes, not 27) qualifies for larger chunks.

    Desync-proof by construction: the count is taken by DRIVING
    :func:`accumulate_taps` itself with a counting ``term``/``scalar``
    stub — tallying emitted terms plus the distinct ``xsum``/``ysum``
    cache keys implementations hold live — so any future change to the
    emission (new factoring level, different caching) changes this
    estimate automatically."""
    flat = flat_taps(taps)
    n_terms = 0
    caches = set()
    tok = _CountToken()

    def term(di, dj, dk):
        nonlocal n_terms
        n_terms += 1
        if di == "xsum":
            caches.add("p")
        if dj == "ysum":
            caches.add(("ys", di))
        return tok

    accumulate_taps(flat, term, lambda w: tok)
    return n_terms + len(caches)


def decompose_mehrstellen(taps: np.ndarray):
    """Factor 3x3x3 update taps as ``T = a*delta + b*S + d*F`` where
    ``S = [1,3,1] (x) [1,3,1] (x) [1,3,1]`` (fully separable) and ``F`` is
    the 6-face indicator — or None when the set doesn't decompose (or has
    no separable part, b == 0, where the factored tap chain already wins).

    The isotropic 27-point update taps decompose exactly (their
    corner:edge ratio is 1:3 by construction), which turns the 27-tap
    apply into three 1D [1,3,1] convolutions (2 ops each, shifted reads
    reusable across axes) plus a 7-point face correction — the candidate
    route for the VPU-bound 27pt chain (see scripts/roofline_check.py
    --fit). Returns (a, b, d) floats."""
    t = np.asarray(taps, dtype=np.float64)
    b = float(t[0, 0, 0])
    if b == 0.0:
        return None
    d = float(t[0, 1, 1]) - 9.0 * b
    a = float(t[1, 1, 1]) - 27.0 * b
    recon = np.full((3, 3, 3), b)
    for axis_val in range(3):
        idx = [slice(None)] * 3
        idx[axis_val] = 1
        recon[tuple(idx)] *= 3.0
    for off in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        recon[off] += d
    recon[1, 1, 1] += a
    scale = np.max(np.abs(t)) or 1.0
    if not np.allclose(recon, t, rtol=0, atol=1e-12 * scale):
        return None
    return a, b, d


# Vector ops/cell/update of the canonical mehrstellen emission (the order
# pinned in ops.stencil_jnp._apply_mehrstellen_padded's docstring):
# z131 2 + y131 2 + S 2 + px/py/pz 3 + psum 2 + final combine 3 = 14.
# Lives beside the route gate so count and emission move together;
# pinned against the docstring by tests/test_step_jnp.py.
MEHRSTELLEN_OPS = 14


def mehrstellen_enabled() -> bool:
    """HEAT3D_MEHRSTELLEN (same convention as the sibling factoring knobs:
    unset/'0'/'false' = off) switches eligible stencils (today: the 27pt
    set) to the separable S+F route, implemented in the jnp apply and the
    tb=1/tb=2 direct kernels (whose q-rings cache each plane's 2D conv
    once per stage — the shifted-read reuse the route exists for;
    faces-direct shell patches then match the bulk's route). The windowed
    exchange-path kernels keep the tap chain (their interiors pin their
    jnp faces to the chain). Default OFF until the on-chip A/B lands —
    the committed measured record runs the factored tap chain."""
    import os

    return os.environ.get("HEAT3D_MEHRSTELLEN", "").lower() not in (
        "", "0", "false",
    )


def chain_ops_for(kind: str) -> int:
    """Vector ops/cell/update the named stencil's chain emits under the
    CURRENT factoring env — the one shared derivation for measurement
    provenance (bench.harness records it per row) and analysis fallback
    (scripts/roofline_check.py for rows predating the field). Tap VALUES
    don't affect the count, only which offsets are nonzero, so nominal
    alpha/dt/spacing are used."""
    taps = stencil_taps(
        STENCILS[kind], alpha=0.1, dt=0.05, spacing=(1.0, 1.0, 1.0)
    )
    return effective_num_taps(taps)


def accumulate_taps(taps_flat, term, scalar):
    """THE canonical tap-accumulation order, shared by every compute
    backend (jnp path, streaming/windowed/direct Pallas kernels) so
    cross-implementation comparisons — including the faces-direct steps
    that mix kernel bulk with jnp shell patches — agree to FMA rounding.

    ``term(di, dj, dk)`` returns the shifted slice for one tap; ``di`` may
    be the string ``"xsum"``, meaning the slice of the elementwise sum of
    the x-1 and x+1 planes (the x-symmetric factoring — implementations
    should build that sum lazily, once), and ``dj`` may be ``"ysum"``,
    meaning the slice of the sum of the y-1 and y+1 rows OF THE PLANE
    NAMED BY ``di`` (the y-symmetric factoring — likewise cached per
    plane). ``scalar(w)`` embeds a tap weight in the compute dtype.
    Order: the factored A chain over the ±x-plane sum (its ysum rows
    first, then its middle row), then the B chain over the middle plane
    (same row order); or the plain lexicographic chain when the set
    doesn't factor. ``HEAT3D_FACTOR_Y=0`` disables the y-level factoring
    (on-chip A/B knob, mirroring HEAT3D_FACTOR_7PT at the x level)."""
    sym = split_x_symmetric(taps_flat)
    if sym is None:
        acc = None
        for di, dj, dk, w in taps_flat:
            t = scalar(w) * term(di, dj, dk)
            acc = t if acc is None else acc + t
        return acc

    factor_y = _factor_y_enabled()

    def emit_plane(di, plane_taps, acc):
        ysym = split_y_symmetric(plane_taps) if factor_y else None
        if ysym is None:
            for dj, dk, w in plane_taps:
                t = scalar(w) * term(di, dj, dk)
                acc = t if acc is None else acc + t
            return acc
        r_taps, m_taps = ysym
        for dk, w in r_taps:
            t = scalar(w) * term(di, "ysum", dk)
            acc = t if acc is None else acc + t
        for dk, w in m_taps:
            t = scalar(w) * term(di, 0, dk)
            acc = t if acc is None else acc + t
        return acc

    a_taps, b_taps = sym
    acc = emit_plane("xsum", a_taps, None)
    return emit_plane(0, b_taps, acc)
