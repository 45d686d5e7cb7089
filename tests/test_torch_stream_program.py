"""The stream kernels' compile-time tap chains, on the CPU.

``ops.stencil_stream.CHAINS`` is the table of emission programs that have a
kernel instance of their own; the build hands it to ``nvcc``
(``ops._build.source_flags``) and the wrapper picks the instance by comparing
the emission program's ``(src, row, dk)`` sequence with it. These tests hold
that choice against the emission program, and the emission program against
the JAX package's ``accumulate_taps`` (the order every reference kernel
keeps), for every stencil under every setting of the factoring knobs. The
kernels themselves are held bitwise to their plain versions on the card
(tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from heat3d_tpu.core import stencils as ref_stencils
from heat3d_tpu_torch.core.config import BoundaryCondition, GridConfig
from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps
from heat3d_tpu_torch.ops import _build
from heat3d_tpu_torch.ops import stencil_stream as ss
from heat3d_tpu_torch.parallel.halo import exchange_halo

# the instance each stencil takes under the default knobs
DEFAULT_INSTANCE = {"7pt": 1, "27pt": 2}


def _taps(kind, spacing=(1.0, 1.0, 1.0), n=16):
    g = GridConfig(shape=(n, n, n))
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), spacing)


def _ref_sequence(taps):
    """The JAX package's emission order of ``taps`` as (src, row, dk)."""
    entries = []

    def term(di, dj, dk):
        entries.append((3 if di == "xsum" else di + 1, 3 if dj == "ysum" else dj + 1, dk))
        return 0.0

    ref_stencils.accumulate_taps(ref_stencils.flat_taps(taps), term, lambda w: 0.0)
    return tuple(entries)


def _knobs(monkeypatch, factor_7pt, factor_y):
    if factor_7pt is None:
        monkeypatch.delenv("HEAT3D_FACTOR_7PT", raising=False)
    else:
        monkeypatch.setenv("HEAT3D_FACTOR_7PT", factor_7pt)
    monkeypatch.setenv("HEAT3D_FACTOR_Y", factor_y)


@pytest.mark.parametrize("factor_y", ["1", "0"])
@pytest.mark.parametrize("factor_7pt", [None, "1"], ids=["f7unset", "f7on"])
@pytest.mark.parametrize("kind", sorted(STENCILS))
def test_instance_is_specialised_exactly_for_table_chains(monkeypatch, kind, factor_7pt,
                                                          factor_y):
    _knobs(monkeypatch, factor_7pt, factor_y)
    taps = _taps(kind)
    seq = ss.chain_sequence(taps)
    assert seq == _ref_sequence(taps)
    code = ss.stream_instance(taps)
    table = {chain: c for c, (_, chain) in ss.CHAINS.items()}
    assert (code != ss.GENERIC) == (seq in table)
    if code != ss.GENERIC:
        assert ss.CHAINS[code][1] == seq
        assert table[seq] == code
    if factor_7pt is None and factor_y == "1":
        # the main path's knobs: both stencils run a specialised instance
        assert code == DEFAULT_INSTANCE[kind]
        assert ss.CHAINS[code][0] == kind


@pytest.mark.parametrize("taps_case", ["anisotropic-7pt", "zero-centre-7pt", "advection",
                                       "asymmetric-27pt"])
def test_other_taps_choose_by_sequence(taps_case):
    """Weights do not choose the instance, the sequence does: anisotropic
    spacing and x-asymmetric weights (an upwind x term) keep the 7pt
    instance, whose lexicographic chain never factors; a zero centre weight
    (dropped from the chain) or a 27pt set without the reflection
    symmetries (27 lexicographic terms) are generic."""
    if taps_case == "anisotropic-7pt":
        taps, want = _taps("7pt", spacing=(1.0, 2.0, 0.5)), 1
    elif taps_case == "zero-centre-7pt":
        taps = _taps("7pt")
        taps[1, 1, 1] = 0.0
        want = ss.GENERIC
    elif taps_case == "advection":
        taps = _taps("7pt")
        taps[0, 1, 1] += 0.01  # upwind in x: the +-x taps differ
        want = 1
    else:
        taps = _taps("27pt")
        taps[0, 0, 0] *= 1.5  # breaks the x and y reflection symmetry
        want = ss.GENERIC
    assert ss.chain_sequence(taps) == _ref_sequence(taps)
    assert ss.stream_instance(taps) == want


def test_nvcc_defines_carry_the_table():
    """The build's flags for the stream kernels are the table, three digits
    a term (src, row, dk + 1), with no comma (nvcc splits -D values at
    commas); the direct kernels take the same table; the library's name
    hashes them."""
    flags = _build.source_flags("stencil_stream")
    assert _build.source_flags("stencil_direct") == flags
    decoded = {}
    for f in flags:
        assert "," not in f
        name, value = f[2:].split("=", 1)
        digits = value.strip('"')
        decoded[name] = tuple((int(digits[i]), int(digits[i + 1]), int(digits[i + 2]) - 1)
                              for i in range(0, len(digits), 3))
    assert decoded == {ss._MACROS[c]: chain for c, (_, chain) in ss.CHAINS.items()}


def test_build_name_follows_the_table(monkeypatch):
    before = _build._target("stencil_stream")
    chains = dict(ss.CHAINS)
    chains[1] = ("7pt", ss.CHAINS[1][1][::-1])
    monkeypatch.setattr(ss, "CHAINS", chains)
    assert _build._target("stencil_stream") != before


def test_cpu_path_counts_no_launch_cells_or_generic():
    ss.reset_launch_counts()
    u = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 5, 6)).astype(np.float32))
    up = exchange_halo(u, BoundaryCondition.DIRICHLET, 0.3, 2)
    for taps in (_taps("7pt"), _taps("27pt")):
        ss.apply_taps_stream(up, taps)
        ss.apply_taps_streamk(up, taps, 2, False, 0.3)
    zero = {"apply_taps_stream": 0, "apply_taps_streamk": 0}
    assert ss.launch_counts() == ss.generic_launch_counts() == ss.cell_counts() == zero


def test_launch_instance_checks_on_cpu():
    """``launch_instance`` forces a kernel instance for a measurement on the
    card: a CPU tensor raises (no plain-version fallback), and so do an
    instance code with no kernel, a depth outside 1..4 and an x-chunk below
    one plane; nothing is counted."""
    ss.reset_launch_counts()
    taps = _taps("7pt")
    up = torch.zeros((8, 8, 8))
    for k in (1, 2, 4):
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            ss.launch_instance(k, ss.GENERIC, up, taps)
    with pytest.raises(ValueError, match="no stream kernel instance 3"):
        ss.launch_instance(2, 3, up, taps)
    with pytest.raises(ValueError, match="no stream kernel instance -1"):
        ss.launch_instance(1, -1, up, taps)
    with pytest.raises(ValueError, match="k in"):
        ss.launch_instance(5, ss.GENERIC, up, taps)
    with pytest.raises(ValueError, match="xchunk must be >= 1"):
        ss.launch_instance(3, ss.GENERIC, up, taps, xchunk=0)
    with pytest.raises(ValueError, match="edges must be 6 flags"):
        ss.launch_instance(2, ss.GENERIC, up, taps, edges=(True,) * 5)
    assert ss.launch_counts() == {"apply_taps_stream": 0, "apply_taps_streamk": 0}
