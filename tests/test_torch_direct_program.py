"""The direct kernels' compile-time tap chains, on the CPU.

``csrc/stencil_direct.cu`` has an instance with the chain fixed at compile
time for each entry of the stream kernels' table
(``ops.stencil_stream.CHAINS``), built from the same ``-D`` flags, and a
generic instance that interprets any other program. These tests hold the
direct wrapper's choice of instance against the table and the emission
program (itself held against the JAX package's ``accumulate_taps``), for
every stencil under every setting of the factoring knobs, and the build
flags and name against the table. The kernels themselves are held bitwise
to their plain versions on the card (tests/test_torch_kernels.py); the
plain versions to the JAX kernels in interpret mode
(tests/test_torch_stencil.py, tests/test_torch_stencil2.py).
"""

import numpy as np
import pytest
import torch

from heat3d_tpu.core import stencils as ref_stencils
from heat3d_tpu_torch.core.config import GridConfig
from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps
from heat3d_tpu_torch.ops import _build
from heat3d_tpu_torch.ops import stencil_direct as sd
from heat3d_tpu_torch.ops import stencil_stream as ss

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
def test_direct_instance_is_specialised_exactly_for_table_chains(monkeypatch, kind,
                                                                 factor_7pt, factor_y):
    """The direct wrapper takes a compile-time instance exactly when the
    emission program's sequence is a ``CHAINS`` entry: under the default
    knobs for both stencils, and the generic instance under
    ``HEAT3D_FACTOR_7PT=1`` (7pt) and ``HEAT3D_FACTOR_Y=0`` (27pt)."""
    _knobs(monkeypatch, factor_7pt, factor_y)
    taps = _taps(kind)
    seq = ss.chain_sequence(taps)
    assert seq == _ref_sequence(taps)
    code = sd.direct_instance(taps)
    assert code == ss.stream_instance(taps)
    table = {chain: c for c, (_, chain) in ss.CHAINS.items()}
    assert (code != ss.GENERIC) == (seq in table)
    if code != ss.GENERIC:
        assert ss.CHAINS[code][1] == seq
    default = factor_7pt is None and factor_y == "1"
    if default:
        assert code == DEFAULT_INSTANCE[kind]
    elif (kind, factor_7pt, factor_y) in (("7pt", "1", "1"), ("7pt", "1", "0"),
                                          ("27pt", None, "0"), ("27pt", "1", "0")):
        assert code == ss.GENERIC


@pytest.mark.parametrize("taps_case,want", [
    ("anisotropic-7pt", 1), ("advection", 1), ("zero-centre-7pt", 0),
    ("asymmetric-27pt", 0), ("random", 0),
])
def test_direct_instance_for_other_taps(taps_case, want):
    """The sequence, not the weights, chooses: anisotropic or x-asymmetric
    7pt weights keep the 7pt instance; a zero centre, a 27pt set without
    its reflection symmetries and random taps are generic."""
    if taps_case == "anisotropic-7pt":
        taps = _taps("7pt", spacing=(1.0, 2.0, 0.5))
    elif taps_case == "advection":
        taps = _taps("7pt")
        taps[0, 1, 1] += 0.01
    elif taps_case == "zero-centre-7pt":
        taps = _taps("7pt")
        taps[1, 1, 1] = 0.0
    elif taps_case == "asymmetric-27pt":
        taps = _taps("27pt")
        taps[0, 0, 0] *= 1.5
    else:
        taps = np.random.default_rng(4).uniform(-0.1, 0.1, (3, 3, 3))
    assert ss.chain_sequence(taps) == _ref_sequence(taps)
    assert sd.direct_instance(taps) == want


def test_direct_source_flags_carry_the_table():
    """The direct source builds with the stream table's ``-D`` flags: each
    chain as digits, no comma (nvcc splits -D values at commas)."""
    flags = _build.source_flags("stencil_direct")
    assert flags == ss.nvcc_defines()
    decoded = {}
    for f in flags:
        assert "," not in f
        name, value = f[2:].split("=", 1)
        digits = value.strip('"')
        assert len(digits) % 3 == 0 and digits.isdigit()
        decoded[name] = tuple((int(digits[i]), int(digits[i + 1]), int(digits[i + 2]) - 1)
                              for i in range(0, len(digits), 3))
    assert decoded == {ss._MACROS[c]: chain for c, (_, chain) in ss.CHAINS.items()}


def test_direct_build_name_follows_the_table_and_header(monkeypatch, tmp_path):
    """The direct library's name hashes the table and the chain header: an
    edited table or an edited ``stencil_chain.cuh`` rebuilds it."""
    before = _build._target("stencil_direct")
    chains = dict(ss.CHAINS)
    chains[2] = ("27pt", ss.CHAINS[2][1][::-1])
    monkeypatch.setattr(ss, "CHAINS", chains)
    assert _build._target("stencil_direct") != before
    monkeypatch.undo()
    assert _build._target("stencil_direct") == before
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC_DIR.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert _build._target("stencil_direct") == before
    header = csrc / "stencil_chain.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._target("stencil_direct") != before
    # the source reaches the chain header through the sweep's header
    assert (_build.CSRC_DIR / "stencil_direct.cu").read_text().count(
        '#include "stencil_direct.cuh"') == 1
    assert (_build.CSRC_DIR / "stencil_direct.cuh").read_text().count(
        '#include "stencil_chain.cuh"') == 1


@pytest.mark.parametrize("shape", [(4, 5, 6), (1, 3, 2)])
def test_cpu_path_counts_no_launch_cells_or_generic(shape):
    """On a CPU tensor the wrappers run their plain versions and count
    nothing, under the default knobs and for taps that would take the
    generic instance."""
    sd.reset_launch_counts()
    u = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    odd = np.random.default_rng(2).uniform(-0.1, 0.1, (3, 3, 3))
    for taps in (_taps("7pt"), _taps("27pt"), odd):
        for periodic, bcv in ((False, 0.3), (True, 0.0)):
            sd.apply_taps_direct(u, taps, periodic, bcv)
            sd.apply_taps_direct2(u, taps, periodic, bcv, out=torch.empty_like(u))
    zero = {"apply_taps_direct": 0, "apply_taps_direct2": 0}
    assert sd.launch_counts() == sd.generic_launch_counts() == sd.cell_counts() == zero


def test_reset_zeroes_every_counter():
    for k in sd.KERNELS:
        k.launches, k.generic_launches, k.cells = 3, 2, 7
    sd.reset_launch_counts()
    assert all(k.launches == k.generic_launches == k.cells == 0 for k in sd.KERNELS)


@pytest.mark.parametrize("shape,tiles,resident,want", [
    ((1024, 1024, 1024), (38, 62), 660, 43),   # 459 tiles: 24 chunks
    ((1024, 1024, 1024), (28, 60), 528, 79),   # 666 tiles: 13 chunks
    ((512, 512, 512), (38, 62), 660, 32),      # capped at _MIN_XCHUNK planes
    ((40, 70, 65), (38, 62), 660, 20),         # short x: two chunks of >= 20
    ((7, 5, 9), (28, 60), 528, 7),             # one tile, one chunk
])
def test_wave_xchunk_aims_for_waves_of_resident_blocks(shape, tiles, resident, want):
    """The compile-time instances cut x into chunks until the launch holds
    ``_WAVES`` waves of the card's resident blocks, chunks no shorter than
    ``_MIN_XCHUNK`` planes; the chunks cover x."""
    got = sd.wave_xchunk(shape[0], -(-shape[1] // tiles[0]) * -(-shape[2] // tiles[1]),
                         resident)
    assert got == want
    chunks = -(-shape[0] // got)
    assert (chunks - 1) * got < shape[0] <= chunks * got
    assert chunks <= -(-shape[0] // sd._MIN_XCHUNK)
