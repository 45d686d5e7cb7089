"""The port's CUDA kernels against their plain PyTorch versions on the card,
bitwise. Marked ``cuda``: they skip on a host without a CUDA device and run
on the GPU with ``python -m pytest tests/test_torch_kernels.py -m cuda``.

Bitwise holds because the kernels evaluate the same tap chain, operation by
operation, with ``__fmul_rn``/``__fadd_rn`` (built with ``--fmad=false``),
and round to bf16 with the same round-to-nearest-even as ``Tensor.to``.
"""

import itertools
import os
import sys

import numpy as np
import pytest
import torch

from heat3d_tpu_torch.core.config import (
    BoundaryCondition, GridConfig, SolverConfig, StencilConfig,
)
from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps
from heat3d_tpu_torch.models.heat3d import HeatSolver3D
from heat3d_tpu_torch.ops import stencil_direct as sd
from heat3d_tpu_torch.ops import stencil_stream as ss
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded
from heat3d_tpu_torch.parallel.halo import exchange_halo

pytestmark = pytest.mark.cuda

PAIRS = [
    (sd.apply_taps_direct, sd.apply_taps_direct_ref),
    (sd.apply_taps_direct2, sd.apply_taps_direct2_ref),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


def _taps(kind):
    g = GridConfig.cube(8)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", [(3, 3, 3), (33, 17, 129), (40, 70, 65), (1, 1, 1),
                                   (2, 3, 5), (4, 45, 130), (5, 77, 125), (6, 39, 127)])
def test_kernel_equals_plain_version(cuda, shape, kind, dtype):
    """The direct kernels on the instance the default knobs pick (the
    compile-time one for both stencils), Dirichlet bc 0 and 0.3 and
    periodic: extents below 2H+1, odd nz (periodic rows whose wrapped
    source starts on the other parity), y and z no multiple of the tiles,
    several tiles each way; each also with the x-chunk forced to 3
    planes."""
    base = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    u = torch.from_numpy(base).to(cuda).to(dtype)
    taps = _taps(kind)
    assert sd.direct_instance(taps) != ss.GENERIC
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        for halo, (kernel, plain) in enumerate(PAIRS, start=1):
            want = plain(u, taps, periodic, bcv)
            got = kernel(u, taps, periodic, bcv)
            chunked = sd.launch_instance(halo, sd.direct_instance(taps), u, taps, periodic,
                                         bcv, xchunk=3)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kernel.__name__, periodic, bcv)
            assert torch.equal(chunked, want), (kernel.__name__, periodic, bcv, "xchunk 3")


def _generic_programs():
    """Programs of no ``CHAINS`` entry: the registry's advection-diffusion
    at vx=2 (six terms, no x+1 tap: the solver's generic instance), a
    random 27-term set (x-1 and x+1 read away from the cell) and heat 7pt
    with a zero centre."""
    from heat3d_tpu_torch import eqn

    g = GridConfig.cube(8)
    adv = eqn.solver_taps(SolverConfig(grid=g, stencil=StencilConfig(kind="7pt"),
                                       equation="advection-diffusion",
                                       eq_params=(("vx", 2.0),)))
    zc = _taps("7pt")
    zc[1, 1, 1] = 0.0
    return {"advection": adv, "random27": np.random.default_rng(6).uniform(-0.1, 0.1, (3, 3, 3)),
            "zero-centre": zc}


def _same(got, want) -> bool:
    """``torch.equal``, NaN in the same cells counting as equal (a random
    program's mixed signs meet infinities of both signs)."""
    nan = want.isnan()
    return torch.equal(got.isnan(), nan) and torch.equal(got.masked_fill(nan, 0),
                                                         want.masked_fill(nan, 0))


@pytest.mark.parametrize("knobs", [{"HEAT3D_FACTOR_7PT": "1"}, {"HEAT3D_FACTOR_Y": "0"},
                                   {"HEAT3D_FACTOR_7PT": "1", "HEAT3D_FACTOR_Y": "0"}, {}],
                         ids=["f7", "fy0", "both", "programs"])
def test_direct_generic_instance_equals_plain_version(cuda, monkeypatch, knobs):
    """Under the factoring knobs the direct kernels take the generic
    instance exactly where the emission program is no ``CHAINS`` entry,
    counted apart, and stay bitwise in fp32 and bf16 compute; the generic
    instance forced on the default 7pt chain is bitwise too. Without a knob
    ("programs"): the generic instance (forced, and as the wrapper picks
    it) on the advection-diffusion vx=2 program, a random 27-term one and
    a zero-centre 7pt one, fp32/bf16 storage x fp32/bf16 compute x
    Dirichlet 0/0.3/periodic, at ragged shapes (nx below 2H+1, odd nz, y
    and z no multiple of the 38 x 62 / 28 x 60 tiles), with the x-chunk
    forced to 3 planes, and on the special-value field (subnormals,
    signed zeros, infinities)."""
    for key, value in knobs.items():
        monkeypatch.setenv(key, value)
    computes = (torch.float32, torch.bfloat16)
    if not knobs:
        progs = _generic_programs()
        shapes = [(1, 1, 1), (2, 3, 5), (4, 45, 130), (5, 77, 125), (40, 70, 65)]
        for name, taps in progs.items():
            assert sd.direct_instance(taps) == ss.GENERIC, name
            for shape in shapes + [(24, 33, 70)]:
                base = (_special_field(shape, 15) if shape == (24, 33, 70) else
                        np.random.default_rng(4).standard_normal(shape).astype(np.float32))
                for dtype, cd in itertools.product((torch.float32, torch.bfloat16), computes):
                    u = torch.from_numpy(base).to(cuda).to(dtype)
                    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
                        for halo, (kernel, plain) in enumerate(PAIRS, start=1):
                            want = plain(u, taps, periodic, bcv, cd)
                            sd.reset_launch_counts()
                            got = kernel(u, taps, periodic, bcv, compute_dtype=cd)
                            chunked = sd.launch_instance(halo, ss.GENERIC, u, taps, periodic,
                                                         bcv, xchunk=3, compute_dtype=cd)
                            torch.cuda.synchronize()
                            what = (name, shape, dtype, cd, periodic, bcv, halo)
                            assert _same(got, want), what
                            assert _same(chunked, want), what + ("xchunk 3",)
                            assert sd.generic_launch_counts()[kernel.__name__] == 2
        return
    shape = (9, 45, 131)
    base = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.from_numpy(base).to(cuda).to(dtype)
        for kind in ("7pt", "27pt"):
            taps = _taps(kind)
            generic = sd.direct_instance(taps) == ss.GENERIC
            sd.reset_launch_counts()
            for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
                for (kernel, plain), cd in itertools.product(PAIRS, computes):
                    got = kernel(u, taps, periodic, bcv, compute_dtype=cd)
                    torch.cuda.synchronize()
                    assert torch.equal(got, plain(u, taps, periodic, bcv, cd)), \
                        (kernel.__name__, kind, periodic, bcv, cd)
            launches = sd.launch_counts()
            assert sd.generic_launch_counts() == (launches if generic else
                                                  {n: 0 for n in launches})
    monkeypatch.delenv("HEAT3D_FACTOR_7PT", raising=False)
    monkeypatch.delenv("HEAT3D_FACTOR_Y", raising=False)
    taps = _taps("7pt")
    u = torch.from_numpy(base).to(cuda)
    for (halo, (_, plain)), cd in itertools.product(enumerate(PAIRS, start=1), computes):
        got = sd.launch_instance(halo, ss.GENERIC, u, taps, False, 0.3, compute_dtype=cd)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(u, taps, False, 0.3, cd))


def test_direct_instances_fit_and_raise_without_fallback(cuda):
    """Every direct instance fits an SM, the compile-time ones four blocks
    of 256 threads; a compile-time instance given another chain refuses
    the launch and the wrapper raises (no fallback to another instance);
    a bf16 field must start on a 4-byte boundary."""
    for halo in (1, 2):
        for code in (ss.GENERIC, *ss.CHAINS):
            for dtype, cd in itertools.product((torch.float32, torch.bfloat16), repeat=2):
                r = sd.instance_resources(halo, code, dtype, cd)
                # the generic instance: four blocks at halo 1, three at 2
                want = 4 if code != ss.GENERIC else 5 - halo
                assert r["blocks_per_sm"] >= want, (halo, code, dtype, cd, r)
    u = torch.rand((8, 8, 8), device=cuda)
    sd.reset_launch_counts()
    with pytest.raises(RuntimeError, match="bad arguments"):
        sd.launch_instance(1, 2, u, _taps("7pt"))
    with pytest.raises(RuntimeError, match="bad arguments"):
        sd.launch_instance(2, 1, u, _taps("27pt"))
    assert sd.launch_counts() == {"apply_taps_direct": 0, "apply_taps_direct2": 0}
    flat = torch.zeros(10**3 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="4-byte boundary"):
        sd.apply_taps_direct(flat[1:].view(10, 10, 10), _taps("7pt"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 3, 5), (3, 9, 67), (5, 77, 125),
                                   (6, 39, 127), (33, 17, 129), (40, 70, 65), (70, 45, 131),
                                   (5, 28, 60), (4, 29, 61), (6, 4, 33), (3, 57, 121),
                                   (7, 31, 64)])
def test_mehrstellen_instance_equals_plain_version(cuda, monkeypatch, shape, dtype):
    """Under ``HEAT3D_MEHRSTELLEN`` the 27pt direct launches take the
    compile-time Mehrstellen instance (counted in ``mehrstellen_launches``)
    and equal its plain version bitwise, Dirichlet bc 0 and 0.3 and
    periodic, at halo 1 and 2: extents below 2H+1, odd nz, y and z no
    multiple of the tiles, and several x-chunks (the wrapper's, and forced
    to 3 planes); for the two-update instance's rows owned in runs of four,
    y extents of exactly one tile (28) and one more, of one run (4), of two
    tiles and one, and of a run short of the frame (31)."""
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
    base = np.random.default_rng(13).standard_normal(shape).astype(np.float32)
    u = torch.from_numpy(base).to(cuda).to(dtype)
    taps = _taps("27pt")
    assert sd.direct_instance(taps) == sd.MEHRSTELLEN
    sd.reset_launch_counts()
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        for halo, (kernel, plain) in enumerate(PAIRS, start=1):
            want = plain(u, taps, periodic, bcv)
            got = kernel(u, taps, periodic, bcv)
            chunked = sd.launch_instance(halo, sd.MEHRSTELLEN, u, taps, periodic, bcv,
                                         xchunk=3)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kernel.__name__, periodic, bcv)
            assert torch.equal(chunked, want), (kernel.__name__, periodic, bcv, "xchunk 3")
    assert sd.mehrstellen_launch_counts() == sd.launch_counts() == {
        "apply_taps_direct": 6, "apply_taps_direct2": 6}
    assert sd.generic_launch_counts() == {"apply_taps_direct": 0, "apply_taps_direct2": 0}


def test_mehrstellen_instance_fits_and_raises_without_fallback(cuda, monkeypatch):
    """The Mehrstellen instances fit their launch bounds' blocks of 256
    threads an SM: the one-update instance three (bf16 storage four), the
    two-update one two (its two rings of planes live in registers); their
    tiles are the chains' 38 x 62 and the two-update frame's 28 x 28;
    forced on taps that do not decompose the launch raises, and a 7pt
    solve under the knob keeps its chain instance."""
    lib = sd._lib()
    tiles = [(lib.heat3d_direct_tile_y(h, sd.MEHRSTELLEN),
              lib.heat3d_direct_tile_z(h, sd.MEHRSTELLEN)) for h in (1, 2)]
    assert tiles == [(38, 62), (28, 28)]
    for halo in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            for compute in (torch.float32, torch.bfloat16):
                r = sd.instance_resources(halo, sd.MEHRSTELLEN, dtype, compute)
                want = 2 if halo == 2 else 4 if dtype == torch.bfloat16 else 3
                assert r["blocks_per_sm"] >= want, (halo, dtype, compute, r)
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
    u = torch.rand((8, 8, 8), device=cuda)
    sd.reset_launch_counts()
    with pytest.raises(ValueError, match="a\\*delta"):
        sd.launch_instance(1, sd.MEHRSTELLEN, u, _taps("7pt"))
    sd.apply_taps_direct2(u, _taps("7pt"))
    assert sd.mehrstellen_launch_counts() == {"apply_taps_direct": 0, "apply_taps_direct2": 0}
    assert sd.launch_counts() == {"apply_taps_direct": 0, "apply_taps_direct2": 1}


@pytest.mark.parametrize("tb", [1, 2])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_mehrstellen_sharded_solve_equals_single_shard_on_card(cuda, monkeypatch, tb,
                                                               storage):
    """Under the knob the (2,2,2) faces-direct solve (Mehrstellen instance
    on each shard, Mehrstellen plain shells) equals the (1,1,1) solve."""
    from heat3d_tpu_torch.core.config import MeshConfig, Precision

    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")

    def solve(mesh):
        cfg = SolverConfig(grid=GridConfig(shape=(24, 20, 70)),
                           stencil=StencilConfig(kind="27pt", bc_value=0.3),
                           mesh=MeshConfig(shape=mesh), time_blocking=tb,
                           precision=Precision(storage=storage))
        solver = HeatSolver3D(cfg, device=cuda)
        return solver.gather(solver.run(solver.init_state("random"), 9))

    sd.reset_launch_counts()
    want = solve((1, 1, 1))
    assert sum(sd.mehrstellen_launch_counts().values()) > 0
    assert solve((2, 2, 2)).tobytes() == want.tobytes()


def test_launch_counts_and_out_checks(cuda):
    u = torch.rand((8, 8, 8), device=cuda)
    taps = _taps("7pt")
    sd.reset_launch_counts()
    out = torch.empty_like(u)
    assert sd.apply_taps_direct(u, taps, out=out).data_ptr() == out.data_ptr()
    sd.apply_taps_direct2(u, taps)
    assert sd.launch_counts() == {"apply_taps_direct": 1, "apply_taps_direct2": 1}
    with pytest.raises(ValueError, match="overlaps"):
        sd.apply_taps_direct(u, taps, out=u)
    with pytest.raises(ValueError, match="contiguous"):
        sd.apply_taps_direct(u.transpose(0, 2), taps)
    with pytest.raises(ValueError, match="dtype"):
        sd.apply_taps_direct(u.half(), taps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", [(3, 9, 67), (4, 4, 4), (33, 17, 129), (40, 70, 65),
                                   (1, 1, 1), (2, 1, 3), (5, 61, 131), (70, 39, 63)])
def test_stream_kernels_equal_plain_versions(cuda, monkeypatch, shape, kind, dtype):
    """Includes extents of exactly max(3, k) and x-chunks cut inside the
    ghost rings (33 and 40 planes run as two chunks); extents that are no
    multiple of the specialised instances' tiles in y (24-38 rows) or z
    (56-62 columns), or of the x-chunk (70 planes: 24 + 24 + 22); and
    extents down to 1, where streamk runs on a random padded block (the
    exchange needs extents >= k). Each case runs the instance the default
    knobs pick (specialised for both stencils) and the generic instance
    (``HEAT3D_FACTOR_7PT=1`` and ``HEAT3D_FACTOR_Y=0``)."""
    base = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    u = torch.from_numpy(base).to(cuda).to(dtype)
    rng = np.random.default_rng(6)
    for generic in (False, True):
        if generic:
            monkeypatch.setenv("HEAT3D_FACTOR_7PT", "1")
            monkeypatch.setenv("HEAT3D_FACTOR_Y", "0")
        taps = _taps(kind)
        assert (ss.stream_instance(taps) == ss.GENERIC) == generic
        ss.reset_launch_counts()
        for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
            bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
            up = exchange_halo(u, bc, bcv, 1)
            got = ss.apply_taps_stream(up, taps)
            torch.cuda.synchronize()
            assert torch.equal(got, apply_taps_padded(up, taps)), (periodic, bcv, generic)
            for k in ss.STREAMK_DEPTHS:
                if k <= min(shape):
                    upk = exchange_halo(u, bc, bcv, k)
                else:
                    upk = torch.from_numpy(rng.standard_normal(
                        tuple(n + 2 * k for n in shape)).astype(np.float32)).to(cuda).to(dtype)
                got = ss.apply_taps_streamk(upk, taps, k, periodic, bcv)
                want = ss.apply_taps_streamk_ref(upk, taps, k, periodic, bcv)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (k, periodic, bcv, generic)
        launches = ss.launch_counts()
        assert ss.generic_launch_counts() == (launches if generic else
                                              {n: 0 for n in launches})
        assert ss.cell_counts()["apply_taps_stream"] == 3 * u.numel()


@pytest.mark.parametrize("tb", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
def test_exchange_path_solve_equals_direct_solve(cuda, monkeypatch, tb, kind):
    """k steps on the exchange path (stream kernel at tb=1, streamk at
    tb=2..4) equal k direct-kernel steps bitwise."""
    def solve(time_blocking):
        cfg = SolverConfig(grid=GridConfig(shape=(24, 20, 70)),
                           stencil=StencilConfig(kind=kind, bc_value=0.3),
                           time_blocking=time_blocking)
        solver = HeatSolver3D(cfg)
        return solver.run(solver.init_state("random"), tb)

    want = solve(1)
    monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    ss.reset_launch_counts()
    got = solve(tb)
    assert ss.launch_counts()["apply_taps_stream" if tb == 1 else "apply_taps_streamk"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_stream_launch_counts_and_out_checks(cuda):
    taps = _taps("7pt")
    up = torch.rand((10, 10, 10), device=cuda)
    ss.reset_launch_counts()
    out = torch.empty((8, 8, 8), device=cuda)
    assert ss.apply_taps_stream(up, taps, out=out).data_ptr() == out.data_ptr()
    ss.apply_taps_stream2(up[:8, :8, :8].contiguous(), taps)
    ss.apply_taps_streamk(up, taps, 3)
    assert ss.launch_counts() == {"apply_taps_stream": 1, "apply_taps_streamk": 2}
    with pytest.raises(ValueError, match="out must match"):
        ss.apply_taps_stream(up, taps, out=torch.empty_like(up))
    with pytest.raises(ValueError, match="overlaps"):
        ss.apply_taps_stream(up, taps, out=up.view(-1)[: 8**3].view(8, 8, 8))


def test_stream_instances_fit_and_check_alignment(cuda):
    """Every instance fits an SM; the specialised streamk K=4 instances keep
    four blocks of 256 threads on one (the design's register and shared
    memory budget), the generic instance two at every k in fp32, in both
    compute policies. A compile-time instance given another chain refuses
    the launch and the wrapper raises (no fallback to another instance). A
    bf16 padded field must start on a 4-byte boundary (its rows are copied
    as element pairs)."""
    for k in (1, *ss.STREAMK_DEPTHS):
        for code in (ss.GENERIC, *ss.CHAINS):
            for dtype, cd in itertools.product((torch.float32, torch.bfloat16), repeat=2):
                r = ss.instance_resources(k, code, dtype, cd)
                want = (4 if code != ss.GENERIC and k == 4 else
                        2 if code == ss.GENERIC and dtype == torch.float32 else 1)
                assert r["blocks_per_sm"] >= want, (k, code, dtype, cd, r)
    up = torch.rand((10, 10, 10), device=cuda)
    ss.reset_launch_counts()
    with pytest.raises(RuntimeError, match="bad arguments"):
        ss.launch_instance(1, 2, up, _taps("7pt"))
    with pytest.raises(RuntimeError, match="bad arguments"):
        ss.launch_instance(2, 1, up, _taps("27pt"))
    assert ss.launch_counts() == {"apply_taps_stream": 0, "apply_taps_streamk": 0}
    flat = torch.zeros(10**3 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="4-byte boundary"):
        ss.apply_taps_stream(flat[1:].view(10, 10, 10), _taps("7pt"))


# Dirichlet domain-edge masks of the stream generic cases: the whole domain,
# an interior shard's and a mixed one
_EDGE_MASKS = ((True,) * 6, (False,) * 6, (True, False, False, True, True, False))


@pytest.mark.parametrize("program", ["7pt", "27pt", "f7", "fy0", "advection", "random27",
                                     "zero-centre", "asym27"])
def test_stream_generic_instance_equals_plain_version(cuda, monkeypatch, program):
    """The stream kernels' generic instance forced
    (``ss.launch_instance(k, 0, ...)``) at k = 1..4 on the 7pt and 27pt
    chains, both factoring knobs' programs (``HEAT3D_FACTOR_7PT=1``,
    ``HEAT3D_FACTOR_Y=0``: also as the wrapper picks it), the
    advection-diffusion vx=2, random 27-term, zero-centre and asymmetric
    27pt programs: random padded blocks of ragged interiors (extents below
    2k+1, odd nz, y and z no multiple of the 38 x 62 .. 24 x 56 tiles) with
    the wrapper's x-chunk and chunks of 3 and 1 planes, and the
    special-value field, fp32/bf16 storage x fp32/bf16 compute x Dirichlet
    0/0.3 under three edge masks and periodic, bitwise; every launch
    counted on the generic instance."""
    knobs = {"f7": {"HEAT3D_FACTOR_7PT": "1"}, "fy0": {"HEAT3D_FACTOR_Y": "0"}}
    for key, value in knobs.get(program, {}).items():
        monkeypatch.setenv(key, value)
    progs = _generic_programs()
    asym = _taps("27pt")
    asym[0, 0, 0] *= 1.5
    asym[2, 1, 0] *= 0.7
    progs["asym27"] = asym
    taps = progs.get(program, _taps("27pt" if program in ("27pt", "fy0") else "7pt"))
    if program not in ("7pt", "27pt"):
        assert ss.stream_instance(taps) == ss.GENERIC
    rng = np.random.default_rng(17)
    computes = (torch.float32, torch.bfloat16)
    for k in (1, *ss.STREAMK_DEPTHS):
        wrapper = ss.apply_taps_stream if k == 1 else ss.apply_taps_streamk
        fields = [rng.standard_normal(tuple(m + 2 * k for m in shape)).astype(np.float32)
                  for shape in ((1, 1, 1), (2, 3, 5), (5, 77, 125), (33, 17, 129))]
        fields.append(_special_field((24 + 2 * k, 33 + 2 * k, 70 + 2 * k), 5))
        for base, dtype, cd in itertools.product(fields, computes, computes):
            up = torch.from_numpy(base).to(cuda).to(dtype)
            for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
                for edges in _EDGE_MASKS if k > 1 and not periodic else _EDGE_MASKS[:1]:
                    want = (apply_taps_padded(up, taps, compute_dtype=cd) if k == 1 else
                            ss.apply_taps_streamk_ref(up, taps, k, periodic, bcv, edges, cd))
                    ss.reset_launch_counts()
                    for chunk in (None, 3, 1):
                        got = ss.launch_instance(k, ss.GENERIC, up, taps, periodic, bcv,
                                                 edges=edges, xchunk=chunk, compute_dtype=cd)
                        torch.cuda.synchronize()
                        assert _same(got, want), (program, k, tuple(up.shape), dtype, cd,
                                                  periodic, bcv, edges, chunk)
                    if program in knobs:
                        got = (ss.apply_taps_stream(up, taps, compute_dtype=cd) if k == 1 else
                               ss.apply_taps_streamk(up, taps, k, periodic, bcv, edges=edges,
                                                     compute_dtype=cd))
                        torch.cuda.synchronize()
                        assert _same(got, want), (program, k, "as the wrapper picks it")
                    n = 3 + (program in knobs)
                    assert ss.generic_launch_counts()[wrapper.__name__] == n


def _card_mesh(cuda, shape, local):
    from heat3d_tpu_torch.parallel.topology import ShardMesh

    n = shape[0] * shape[1] * shape[2]
    return ShardMesh(shape, local, [cuda] * n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 2), (3, 1, 2)])
def test_dma_exchange_equals_plain_version(cuda, mesh_shape, dtype):
    """Every shard on one card, each on its own stream: the push/wait
    kernels against their plain version (the ppermute slab copies), 10
    exchanges in a row per plan, widths 1-4, three boundary settings."""
    from heat3d_tpu_torch.ops import halo_dma
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    local = (6, 5, 9)
    mesh = _card_mesh(cuda, mesh_shape, local)
    rng = np.random.default_rng(9)
    halo_dma.reset_launch_counts()
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
        for width in (1, 2, 3, 4):
            dma = ExchangePlan(mesh, bc, width, "dma", dtype)
            ref = ExchangePlan(mesh, bc, width, "ppermute", dtype)
            for _ in range(10):
                us = [torch.from_numpy(rng.standard_normal(local).astype(np.float32))
                      .to(cuda).to(dtype) for _ in mesh.shards]
                mesh.fork()
                got = dma.apply(us, bcv)
                want = ref.apply(us, bcv)
                mesh.join()  # the blocks are written on the shard streams
                torch.cuda.synchronize()
                halo_dma.raise_if_timed_out()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (periodic, bcv, width)
    assert halo_dma.launch_counts()["halo_dma"] > 0


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (3, 1, 2), (1, 2, 1)])
def test_dma_exchange_odd_extents_bf16(cuda, mesh_shape):
    """bf16 blocks of odd extents, so padded rows start on either 4-byte
    parity and the push copies them in the widest vectors each row allows:
    widths 1-4, three boundary settings, 3 exchanges a plan, against the
    ppermute slab copies; each axis one push and one wait launch on the
    one card."""
    from heat3d_tpu_torch.ops import halo_dma
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    local = (7, 5, 9)
    mesh = _card_mesh(cuda, mesh_shape, local)
    rng = np.random.default_rng(10)
    axes = sum(1 for n in mesh_shape if n > 1)
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
        for width in (1, 2, 3, 4):
            dma = ExchangePlan(mesh, bc, width, "dma", torch.bfloat16)
            ref = ExchangePlan(mesh, bc, width, "ppermute", torch.bfloat16)
            for _ in range(3):
                us = [torch.from_numpy(rng.standard_normal(local).astype(np.float32))
                      .to(cuda).to(torch.bfloat16) for _ in mesh.shards]
                before = halo_dma.launch_counts()["halo_dma"]
                mesh.fork()
                got = dma.apply(us, bcv)
                want = ref.apply(us, bcv)
                mesh.join()
                torch.cuda.synchronize()
                halo_dma.raise_if_timed_out()
                assert halo_dma.launch_counts()["halo_dma"] - before == 2 * axes
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (periodic, bcv, width)


def test_streamk_edge_mask_equals_plain_version(cuda):
    """Each shard of a (3,1,2) mesh with its own domain-edge mask."""
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    local = (6, 9, 7)
    mesh = _card_mesh(cuda, (3, 1, 2), local)
    taps = _taps("27pt")
    rng = np.random.default_rng(4)
    for k in ss.STREAMK_DEPTHS:
        plan = ExchangePlan(mesh, BoundaryCondition.DIRICHLET, k, "ppermute", torch.float32)
        us = [torch.from_numpy(rng.standard_normal(local).astype(np.float32)).to(cuda)
              for _ in mesh.shards]
        mesh.fork()
        pads = plan.apply(us, 0.3)
        mesh.join()
        for s in mesh.shards:
            got = ss.apply_taps_streamk(pads[s.rank], taps, k, False, 0.3, edges=s.edges)
            want = ss.apply_taps_streamk_ref(pads[s.rank], taps, k, False, 0.3, s.edges)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, s.coords)


@pytest.mark.parametrize("tb,halo,no_direct", [
    (1, "ppermute", False), (2, "ppermute", False), (3, "ppermute", False),
    (4, "ppermute", False), (1, "ppermute", True), (1, "dma", False),
    (2, "dma", False), (4, "dma", False)])
def test_sharded_solve_equals_single_shard_on_card(cuda, monkeypatch, tb, halo, no_direct):
    from heat3d_tpu_torch.core.config import MeshConfig

    def solve(mesh, time_blocking, halo):
        cfg = SolverConfig(grid=GridConfig(shape=(24, 20, 70)),
                           stencil=StencilConfig(kind="7pt", bc_value=0.3),
                           mesh=MeshConfig(shape=mesh), halo=halo,
                           time_blocking=time_blocking)
        solver = HeatSolver3D(cfg, device=cuda)
        return solver.gather(solver.run(solver.init_state("random"), 9))

    want = solve((1, 1, 1), 1, "ppermute")
    if no_direct:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    got = solve((2, 2, 2), tb, halo)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("tb,periodic", [(4, True), (4, False), (2, False)])
def test_dma_plan_built_mid_run_on_busy_streams(cuda, tb, periodic):
    """1024^3 on (2,2,2), every shard on one card, ``halo='dma'``, 11 steps:
    the width-1 plan of the remainder steps is built while the supersteps
    still run on the eight shard streams. Its flag words must be zeroed in
    stream order before any neighbour signals them; zeroed out of order
    (on the caller's stream, which shares a hardware queue with a busy
    shard stream), a signal is lost and a wait times out. The result
    equals the (1,1,1) solve bitwise."""
    from heat3d_tpu_torch.core.config import MeshConfig
    from heat3d_tpu_torch.ops import halo_dma

    bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET

    def solve(mesh, time_blocking, halo):
        cfg = SolverConfig(grid=GridConfig.cube(1024),
                           stencil=StencilConfig(kind="7pt", bc=bc,
                                                 bc_value=0.0 if periodic else 0.3),
                           mesh=MeshConfig(shape=mesh), halo=halo,
                           time_blocking=time_blocking)
        solver = HeatSolver3D(cfg, device=cuda)
        return solver, solver.run(solver.init_state("hot-cube"), 11)

    _, want = solve((1, 1, 1), 1, "ppermute")
    solver, got = solve((2, 2, 2), tb, "dma")
    torch.cuda.synchronize()
    halo_dma.raise_if_timed_out()
    for s, shard in zip(solver.mesh.shards, got.shards):
        region = tuple(slice(o, o + n) for o, n in zip(s.origin, solver.mesh.local_shape))
        assert torch.equal(shard, want[region]), s.coords


def _split(u, mesh):
    return [u[tuple(slice(o, o + n) for o, n in zip(s.origin, mesh.local_shape))].contiguous()
            for s in mesh.shards]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mesh_shape,shape", [
    ((4, 1, 1), (16, 20, 70)), ((2, 1, 1), (8, 33, 65)), ((3, 1, 1), (18, 17, 40)),
    ((2, 2, 2), (12, 20, 70)), ((2, 1, 3), (8, 9, 66))])
def test_fused_kernels_equal_plain_versions(cuda, mesh_shape, shape, dtype):
    """The four fused kernels (fused DMA tb 1/2, fused RDMA tb 1/2 with the
    plan's ranges), every shard on one card in one launch, against their
    plain versions, five launches in a row per state; the landed ghosts of
    ``return_ghosts`` too. The tb=2 kernel only on x-slab meshes."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    local = tuple(g // p for g, p in zip(shape, mesh_shape))
    mesh = _card_mesh(cuda, mesh_shape, local)
    rng = np.random.default_rng(11)
    slab = mesh_shape[1] == mesh_shape[2] == 1
    fd.reset_launch_counts()
    fr.reset_launch_counts()
    for kind in ("7pt", "27pt"):
        taps = _taps(kind)
        for periodic, bcv in ((False, 0.3), (True, 0.0)):
            for tb in ((1, 2) if slab and local[0] >= 4 else (1,)):
                for bounds, fns in (
                    (None, (fd.apply_step_fused_dma, fd.apply_superstep_fused_dma)),
                    (partition_bounds(local[1], 3),
                     (fr.apply_step_fused_rdma, fr.apply_superstep_fused_rdma)),
                ):
                    state = fd.FusedState(mesh, tb, dtype, periodic, bounds)
                    for _ in range(5):
                        u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                        us = _split(u.to(cuda).to(dtype), mesh)
                        if tb == 2:
                            got = fns[1](us, taps, mesh, state, periodic, bcv)
                            want = fd.reference_fused_superstep(us, taps, mesh, periodic, bcv)
                            gh = wgh = []
                        elif bounds is None:
                            got, gh = fns[0](us, taps, mesh, state, periodic, bcv,
                                             return_ghosts=True)
                            want, wgh = fd.reference_fused_step(us, taps, mesh, periodic, bcv,
                                                                return_ghosts=True)
                            gh = [tuple(x.clone() for x in g) for g in gh]
                        else:
                            got = fns[0](us, taps, mesh, state, periodic, bcv)
                            want = fd.reference_fused_step(us, taps, mesh, periodic, bcv)
                            gh = wgh = []
                        torch.cuda.synchronize()
                        fd.raise_if_timed_out()
                        for g, w in zip(got, want):
                            assert torch.equal(g, w), (kind, periodic, tb, bounds)
                        for g, w in zip(gh, wgh):
                            assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert fd.launch_counts()["apply_step_fused_dma"] > 0
    assert fr.launch_counts()["apply_step_fused_rdma"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("halo,mesh_shape,shape,parts", [
    (1, (8, 1, 1), (64, 40, 70), 1), (1, (4, 1, 1), (16, 20, 70), 3),
    (1, (2, 2, 2), (12, 20, 70), 1), (1, (2, 1, 1), (4, 77, 125), 2),
    (2, (8, 1, 1), (64, 40, 70), 1), (2, (4, 1, 1), (16, 20, 70), 3),
    (2, (2, 1, 1), (8, 77, 125), 2), (2, (2, 1, 1), (8, 77, 125), 3)])
def test_fused_compile_time_and_generic_instances_equal(cuda, halo, mesh_shape, shape, parts,
                                                        dtype):
    """The fused kernel's compile-time instance of ``halo`` updates (the one
    the 7pt and 27pt taps take) and its generic instance forced, both
    bitwise equal to the plain version: x-slabs with whole-face and
    partitioned send ranges, the 3D mesh (one update), and a ragged, odd
    ny*nz at nx = 2H a shard (bf16 planes, the landed ones too, start on
    either parity)."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    # the generic instance keeps three fp32 blocks an SM in both policies
    for cd in (torch.float32, torch.bfloat16):
        r = fd.instance_resources(halo, ss.GENERIC, torch.float32, cd)
        assert r["blocks_per_sm"] >= 3, (halo, cd, r)
    local = tuple(g // p for g, p in zip(shape, mesh_shape))
    mesh = _card_mesh(cuda, mesh_shape, local)
    u = torch.from_numpy(np.random.default_rng(14).standard_normal(shape).astype(np.float32))
    us = _split(u.to(cuda).to(dtype), mesh)
    bounds = None if parts == 1 else partition_bounds(local[1], parts)
    wrapper = fd.KERNELS[halo - 1]
    plain = fd.reference_fused_step if halo == 1 else fd.reference_fused_superstep
    for kind in ("7pt", "27pt"):
        taps = _taps(kind)
        inst = fd.fused_instance(halo, taps)
        assert inst != 0
        for periodic, bcv in ((False, 0.3), (True, 0.0)):
            state = fd.FusedState(mesh, halo, dtype, periodic, bounds)
            want = plain(us, taps, mesh, periodic, bcv)
            for instance in (inst, 0):
                before = fd.generic_launch_counts()[wrapper.__name__]
                got = fd.launch_instance(instance, us, taps, mesh, state, periodic, bcv)
                torch.cuda.synchronize()
                fd.raise_if_timed_out()
                took = fd.generic_launch_counts()[wrapper.__name__] - before
                assert took == (instance == 0)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (kind, periodic, instance)


# (mesh, global field, send ranges a face) of the fused generic cases: an
# x-slab, (4,1,1) with three ranges, the 3D route's (2,2,2) (one update)
# and a ragged, odd ny*nz (bf16 planes, the landed ones too, start on
# either parity)
_FUSED_GENERIC_MESHES = (((8, 1, 1), (64, 40, 70), 1), ((4, 1, 1), (16, 20, 70), 3),
                         ((2, 2, 2), (12, 20, 70), 1), ((2, 1, 1), (8, 77, 125), 1))


@pytest.mark.parametrize("program", ["advection", "zero-centre", "asym27", "random27"])
def test_fused_generic_instance_equals_plain_version(cuda, program):
    """The fused kernels' generic instance forced
    (``fd.launch_instance(0, ...)``), as the wrappers pick it, on the
    advection-diffusion vx=2, zero-centre 7pt, asymmetric 27pt and random
    27-term programs: one and two updates (DMA and RDMA wrappers; one
    update only on the 3D mesh) over ``_FUSED_GENERIC_MESHES``, fp32/bf16
    storage x fp32/bf16 compute x Dirichlet 0.3/periodic, and over (8,1,1)
    on the special-value field; bitwise, NaN in the same cells, every
    launch counted on the generic instance."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    progs = _generic_programs()
    asym = _taps("27pt")
    asym[0, 0, 0] *= 1.5
    asym[2, 1, 0] *= 0.7
    progs["asym27"] = asym
    taps = progs[program]
    assert fd.fused_instance(1, taps) == fd.fused_instance(2, taps) == ss.GENERIC
    computes = (torch.float32, torch.bfloat16)
    fields = [(m, parts, np.random.default_rng(24).standard_normal(shape).astype(np.float32),
               dtype) for m, shape, parts in _FUSED_GENERIC_MESHES for dtype in computes]
    fields.append(((8, 1, 1), 1, _special_field((64, 40, 70), 15), torch.float32))
    for mesh_shape, parts, base, dtype in fields:
        local = tuple(g // p for g, p in zip(base.shape, mesh_shape))
        mesh = _card_mesh(cuda, mesh_shape, local)
        us = _split(torch.from_numpy(base).to(cuda).to(dtype), mesh)
        slab = mesh_shape[1] == mesh_shape[2] == 1
        for halo, cd, (periodic, bcv) in itertools.product(
                (1, 2) if slab else (1,), computes, ((False, 0.3), (True, 0.0))):
            want = (fd.reference_fused_step if halo == 1 else fd.reference_fused_superstep)(
                us, taps, mesh, periodic, bcv, compute_dtype=cd)
            bounds = partition_bounds(local[1], parts) if parts > 1 else None
            for wrapper in (fd.KERNELS[halo - 1], fr.KERNELS[halo - 1])[:1 + slab]:
                state = fd.FusedState(mesh, halo, dtype, periodic, bounds)
                before = wrapper.generic_launches
                forced = fd.launch_instance(ss.GENERIC, us, taps, mesh, state, periodic, bcv,
                                            wrapper=wrapper, compute_dtype=cd)
                forced = [g.clone() for g in forced]
                picked = wrapper(us, taps, mesh, state, periodic, bcv, compute_dtype=cd)
                torch.cuda.synchronize()
                fd.raise_if_timed_out()
                what = (program, mesh_shape, dtype, cd, halo, periodic, bounds)
                for f, g, w in zip(forced, picked, want):
                    assert _same(f, w), what
                    assert _same(g, w), what + ("as the wrapper picks it",)
                assert wrapper.generic_launches == before + 2, what


@pytest.mark.parametrize("halo", [1, 2])
def test_fused_launches_in_a_row_see_fresh_landed_planes(cuda, halo):
    """50 compile-time fused launches of ``halo`` updates on one state, the
    input changed on the shard streams between them and no host sync: each
    launch's skin planes must read the ghosts its own pushes landed, not an
    earlier launch's (a stale read, through L1 or out of order, shows as a
    mismatch)."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    mesh = _card_mesh(cuda, (8, 1, 1), (8, 40, 70))
    taps = _taps("7pt")
    base = _split(torch.from_numpy(np.random.default_rng(15).standard_normal((64, 40, 70))
                                   .astype(np.float32)).to(cuda), mesh)
    state = fd.FusedState(mesh, halo, torch.float32, False, partition_bounds(40, 2))
    kern = fd.KERNELS[halo - 1]
    plain = fd.reference_fused_step if halo == 1 else fd.reference_fused_superstep
    snaps = []
    mesh.fork()
    for i in range(50):
        us = []
        for s, b in zip(mesh.shards, base):
            with mesh.on(s):
                us.append(b * (i + 1))
        outs = kern(us, taps, mesh, state, False, 0.3)
        snap = []
        for s, o in zip(mesh.shards, outs):
            with mesh.on(s):
                snap.append(o.clone())
        snaps.append(snap)
    mesh.join()
    torch.cuda.synchronize()
    fd.raise_if_timed_out()
    for i, snap in enumerate(snaps):
        want = plain([b * (i + 1) for b in base], taps, mesh, False, 0.3)
        for g, w in zip(snap, want):
            assert torch.equal(g, w), i


def test_fused_launch_checks(cuda):
    """Every fused instance fits an SM, the generic one three fp32 blocks in
    both policies; a compile-time instance given another chain refuses the
    launch and the wrapper raises (no fallback to another instance); the
    wrappers check their arguments."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    for halo in (1, 2):
        for code in (ss.GENERIC, *ss.CHAINS):
            for dtype, cd in itertools.product((torch.float32, torch.bfloat16), repeat=2):
                r = fd.instance_resources(halo, code, dtype, cd)
                want = 3 if code == ss.GENERIC and dtype == torch.float32 else 1
                assert r["blocks_per_sm"] >= want, (halo, code, dtype, cd, r)
    mesh = _card_mesh(cuda, (2, 1, 1), (4, 8, 8))
    state = fd.FusedState(mesh, 1, torch.float32, False)
    us = [torch.rand((4, 8, 8), device=cuda) for _ in range(2)]
    taps = _taps("7pt")
    fd.reset_launch_counts()
    with pytest.raises(RuntimeError, match="bad arguments"):
        fd.launch_instance(2, us, taps, mesh, state)
    assert fd.launch_counts()["apply_step_fused_dma"] == 0
    with pytest.raises(ValueError, match="overlaps"):
        fd.apply_step_fused_dma(us, taps, mesh, state, outs=[us[1], torch.empty_like(us[0])])
    with pytest.raises(ValueError, match="want"):
        fd.apply_step_fused_dma([u.double() for u in us], taps, mesh, state)
    with pytest.raises(ValueError, match="width"):
        fd.apply_superstep_fused_dma(us, taps, mesh, state)
    with pytest.raises(ValueError, match="FusedState"):
        fd.apply_step_fused_dma(us, taps, mesh)


@pytest.mark.parametrize("mesh_shape,kw", [
    ((4, 1, 1), dict(overlap=True, halo="dma")),
    ((4, 1, 1), dict(overlap=True, halo="dma", time_blocking=2)),
    ((2, 2, 2), dict(overlap=True, halo="dma")),
    ((4, 1, 1), dict(fused_rdma="on", halo_plan="partitioned")),
    ((4, 1, 1), dict(fused_rdma="on", halo_plan="partitioned", time_blocking=2)),
    ((2, 2, 2), dict(overlap=True, backend="pallas"))])
def test_overlap_routes_equal_single_shard_on_card(cuda, monkeypatch, mesh_shape, kw):
    from heat3d_tpu_torch.core.config import MeshConfig

    monkeypatch.setenv("HEAT3D_PLAN_PART_MIN_BYTES", "0")

    def solve(mesh, **knobs):
        cfg = SolverConfig(grid=GridConfig(shape=(24, 20, 70)),
                           stencil=StencilConfig(kind="27pt", bc_value=0.3),
                           mesh=MeshConfig(shape=mesh), **knobs)
        solver = HeatSolver3D(cfg, device=cuda)
        return solver.gather(solver.run(solver.init_state("random"), 9))

    want = solve((1, 1, 1))
    if mesh_shape == (2, 2, 2) and "halo" not in kw:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")  # the overlap split
    assert solve(mesh_shape, **kw).tobytes() == want.tobytes()


def test_fused_state_built_mid_run_on_busy_streams(cuda):
    """1024^3 on (8,1,1), every shard on one card, ``dma`` + ``overlap``,
    tb=2, 11 steps: the tb=1 kernel's state of the remainder step is built
    while the supersteps still run. It is zeroed on the stream its kernel
    runs on, so no signal is lost; the result equals the (1,1,1) solve
    bitwise."""
    from heat3d_tpu_torch.core.config import MeshConfig
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    def solve(mesh, **knobs):
        cfg = SolverConfig(grid=GridConfig.cube(1024),
                           stencil=StencilConfig(kind="7pt", bc_value=0.3),
                           mesh=MeshConfig(shape=mesh), **knobs)
        solver = HeatSolver3D(cfg, device=cuda)
        return solver, solver.run(solver.init_state("hot-cube"), 11)

    _, want = solve((1, 1, 1))
    fd.reset_launch_counts()
    solver, got = solve((8, 1, 1), halo="dma", overlap=True, time_blocking=2)
    torch.cuda.synchronize()
    fd.raise_if_timed_out()
    assert fd.launch_counts() == {"apply_step_fused_dma": 1, "apply_superstep_fused_dma": 5}
    for s, shard in zip(solver.mesh.shards, got.shards):
        region = tuple(slice(o, o + n) for o, n in zip(s.origin, solver.mesh.local_shape))
        assert torch.equal(shard, want[region]), s.coords


# ---- bf16 compute ------------------------------------------------------------

BF16_KERNELS = ["direct1", "direct2", "direct1_mehrstellen", "direct2_mehrstellen",
                "stream1", "streamk2", "streamk3", "streamk4"]


def _special_field(shape, seed):
    """``chip_smoke.py``'s field of the bf16 format's edges: subnormals,
    signed zeros, infinities and values whose sums overflow, with no NaN
    in any plain output."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke._special_field(shape, seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kernel", BF16_KERNELS)
def test_compute_bf16_instances_equal_plain_versions(cuda, monkeypatch, kernel, dtype):
    """Every stencil kernel's bf16-compute instance (``compute_dtype=
    torch.bfloat16``: the ``Bf16Math`` policy) against its plain version in
    bf16 compute, bitwise, 7pt and 27pt (the Mehrstellen instances 27pt
    under ``HEAT3D_MEHRSTELLEN=1``), Dirichlet bc 0 and 0.3 and periodic,
    at a ragged shape, on a normal field and on one holding subnormals,
    signed zeros, infinities and overflowing values (``_special_field``),
    and with the generic instance forced on the same chain (the chains
    only); each launch counted as one bf16-compute launch."""
    bf = torch.bfloat16
    mehr = kernel.endswith("mehrstellen")
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1" if mehr else "0")
    shape = (37, 45, 131)
    normal = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    for base, kind in itertools.product(
            (normal, _special_field(shape, 14)), ("27pt",) if mehr else ("7pt", "27pt")):
        u = torch.from_numpy(base).to(cuda).to(dtype)
        taps = _taps(kind)
        for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
            bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
            if kernel.startswith("direct"):
                halo = int(kernel[6])
                plain = PAIRS[halo - 1][1](u, taps, periodic, bcv, bf)
                # the generic instance runs the chain, not the Mehrstellen route
                codes = (sd.direct_instance(taps),) + (() if mehr else (ss.GENERIC,))
                runs = [lambda c=c: sd.launch_instance(halo, c, u, taps, periodic, bcv,
                                                       compute_dtype=bf) for c in codes]
                counts = sd.compute_bf16_launch_counts
                name = PAIRS[halo - 1][0].__name__
            else:
                k = 1 if kernel == "stream1" else int(kernel[-1])
                up = exchange_halo(u, bc, bcv, k)
                if k == 1:
                    plain = apply_taps_padded(up, taps, mehrstellen=False, compute_dtype=bf)
                    runs = [lambda: ss.apply_taps_stream(up, taps, compute_dtype=bf)]
                    name = "apply_taps_stream"
                else:
                    plain = ss.apply_taps_streamk_ref(up, taps, k, periodic, bcv,
                                                      compute_dtype=bf)
                    runs = [lambda: ss.apply_taps_streamk(up, taps, k, periodic, bcv,
                                                          compute_dtype=bf)]
                    name = "apply_taps_streamk"
                counts = ss.compute_bf16_launch_counts
            for run in runs:
                before = counts()[name]
                got = run()
                torch.cuda.synchronize()
                assert not plain.isnan().any()
                assert torch.equal(got, plain), (kernel, kind, periodic, bcv)
                assert counts()[name] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mesh_shape,shape", [((8, 1, 1), (64, 40, 70)),
                                              ((4, 1, 1), (16, 20, 70))])
def test_fused_compute_bf16_instances_equal_plain_versions(cuda, mesh_shape, shape, dtype):
    """The four fused kernels' bf16-compute instances (compile-time and
    generic), every shard on one card in one launch, against their plain
    versions in bf16 compute, bitwise; the RDMA ones with three send
    ranges a face."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    bf = torch.bfloat16
    local = tuple(g // p for g, p in zip(shape, mesh_shape))
    mesh = _card_mesh(cuda, mesh_shape, local)
    u = torch.from_numpy(np.random.default_rng(13).standard_normal(shape).astype(np.float32))
    us = _split(u.to(cuda).to(dtype), mesh)
    for kind in ("7pt", "27pt"):
        taps = _taps(kind)
        for periodic, bcv in ((False, 0.3), (True, 0.0)):
            for tb in (1, 2):
                want = (fd.reference_fused_step(us, taps, mesh, periodic, bcv, compute_dtype=bf)
                        if tb == 1 else
                        fd.reference_fused_superstep(us, taps, mesh, periodic, bcv,
                                                     compute_dtype=bf))
                for bounds, wrapper in ((None, (fd.apply_step_fused_dma,
                                                fd.apply_superstep_fused_dma)[tb - 1]),
                                        (partition_bounds(local[1], 3),
                                         (fr.apply_step_fused_rdma,
                                          fr.apply_superstep_fused_rdma)[tb - 1])):
                    state = fd.FusedState(mesh, tb, dtype, periodic, bounds)
                    for instance in (fd.fused_instance(tb, taps), ss.GENERIC):
                        before = wrapper.compute_bf16_launches
                        got = fd.launch_instance(instance, us, taps, mesh, state, periodic,
                                                 bcv, wrapper=wrapper, compute_dtype=bf)
                        torch.cuda.synchronize()
                        fd.raise_if_timed_out()
                        for g, w in zip(got, want):
                            assert torch.equal(g, w), (kind, periodic, tb, bounds, instance)
                        assert wrapper.compute_bf16_launches == before + 1


def _halo_cfg(mesh_shape, halo, storage="float32", order="axis", grid=32, bcv=0.3,
              periodic=False):
    from heat3d_tpu_torch.core.config import MeshConfig, Precision

    bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
    return SolverConfig(grid=GridConfig.cube(grid), mesh=MeshConfig(shape=mesh_shape),
                        stencil=StencilConfig(bc=bc, bc_value=bcv), halo=halo,
                        halo_order=order, precision=Precision(storage=storage))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [7, 4096])
def test_dma_halo_loop_equals_plain_loop(cuda, k, dtype):
    """``bench_halo``'s loop on the DMA transport, k exchanges with no host
    sync between them (epochs 1..k on the same flag words), against the
    same loop on the ppermute transport (the DMA kernels' plain version),
    bitwise: every shard of a (2,2,2) mesh on one card."""
    from heat3d_tpu_torch.bench.harness import halo_loop
    from heat3d_tpu_torch.ops import halo_dma
    from heat3d_tpu_torch.parallel.step import make_exchanges
    from heat3d_tpu_torch.parallel.topology import build_shard_mesh

    rng = np.random.default_rng(17)
    base = [torch.from_numpy(rng.standard_normal((16, 16, 16)).astype(np.float32))
            for _ in range(8)]
    out = {}
    for halo in ("dma", "ppermute"):
        cfg = _halo_cfg((2, 2, 2), halo, dtype)
        mesh = build_shard_mesh(cfg, "cuda:0")
        plan = make_exchanges(cfg, mesh).plan(1, getattr(torch, dtype))
        us = [b.to(cuda).to(plan.dtype) for b in base]
        before = halo_dma.launch_counts()["halo_dma"]
        out[halo] = halo_loop(plan, mesh, us, k, cfg.stencil.bc_value)
        torch.cuda.synchronize()
        halo_dma.raise_if_timed_out()
        launched = halo_dma.launch_counts()["halo_dma"] - before
        assert launched == (6 * k if halo == "dma" else 0)
        if halo == "dma":
            assert plan.dma.epoch == k
    for a, b in zip(out["dma"], out["ppermute"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("halo,order", [("ppermute", "axis"), ("ppermute", "pairwise"),
                                        ("dma", "axis")])
def test_bench_halo_row_on_card(cuda, halo, order):
    """``bench_halo`` on the card: a row of device times for each transport
    and ordering, with the DMA launches counted."""
    from heat3d_tpu_torch.bench.harness import bench_halo

    cfg = _halo_cfg((2, 2, 2), halo, order=order, grid=64)
    row = bench_halo(cfg, iters=3, k=20, device="cuda:0")
    assert row["platform"] == "gpu" and row["device_name"] == torch.cuda.get_device_name(0)
    assert row["p95_mean_us"] >= row["p50_us"] >= row["min_us"] > 0
    assert row["exchanges_per_program"] == 20 and row["shards_per_device"] == 8
    assert (row["halo"], row["halo_order"]) == (halo, order)
    # warmup (2) and 3 programs of 20 exchanges, two launches per axis
    assert row["exchange_kernel_launches"] == (6 * (2 + 3 * 20) if halo == "dma" else 0)


def test_pairwise_exchange_on_card_equals_axis_on_face_ghosts(cuda):
    """The pairwise exchange on a (2,2,2) card mesh equals the axis-ordered
    one on every face-ghost cell, its edge and corner zones at bc, and
    both equal their CPU runs byte for byte."""
    from heat3d_tpu_torch.parallel.plan import ExchangePlan
    from heat3d_tpu_torch.parallel.topology import ShardMesh

    local = (9, 6, 7)
    rng = np.random.default_rng(23)
    base = [torch.from_numpy(rng.standard_normal(local).astype(np.float32)) for _ in range(8)]
    bc = BoundaryCondition.DIRICHLET
    ghost = [torch.zeros(n + 2, dtype=torch.bool) for n in local]
    for g in ghost:
        g[0] = g[-1] = True
    depth = (ghost[0][:, None, None].int() + ghost[1][None, :, None].int()
             + ghost[2][None, None, :].int())
    res = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = ShardMesh((2, 2, 2), local, [dev] * 8)
        us = [b.to(dev) for b in base]
        pw = ExchangePlan(mesh, bc, 1, "ppermute", torch.float32, halo_order="pairwise")
        ax = ExchangePlan(mesh, bc, 1, "ppermute", torch.float32)
        mesh.fork()
        got = [p.clone() for p in pw.apply(us, 0.3)]
        want = [p.clone() for p in ax.apply(us, 0.3)]
        mesh.join()
        res[dev.type] = [g.cpu() for g in got]
        for a, b in zip(got, want):
            a, b = a.cpu(), b.cpu()
            assert torch.equal(a[depth <= 1], b[depth <= 1])
            assert (a[depth >= 2] == torch.tensor(0.3)).all()
    for a, b in zip(res["cuda"], res["cpu"]):
        assert torch.equal(a, b)
