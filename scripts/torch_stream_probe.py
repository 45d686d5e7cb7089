#!/usr/bin/env python3
"""Short on-card probe of the port's stream kernels (csrc/stencil_stream.cu).

    python3 scripts/torch_stream_probe.py

Needs one CUDA GPU. Builds the stream and direct kernel sources, prints the
compiler's register and spill report of every stream instance and each
instance's shared memory and resident blocks per SM, holds every stream and
streamk launch bitwise against its plain version at small ragged shapes
(7pt/27pt x fp32/bf16 x Dirichlet 0/0.3/periodic) and under the factoring
knobs at 128^3 (the generic instance), then times the kernels at 1024^3
(fp32 7pt at k = 1..4 beside the direct kernels; 27pt fp32 and 7pt bf16 at
k = 1 and 4). Prints one JSON line per part. About a minute on an H100: the
first call after a kernel change, before ``chip_smoke.py``.

    python3 scripts/torch_stream_probe.py --generic [--times] [--root DIR]

builds only the stream source, prints the generic instance's registers,
spills, shared memory and blocks per SM (k = 1..4 x fp32/bf16 storage x
both compute policies), holds it forced (``ss.launch_instance(k, 0, ...)``)
on each program of ``GENERIC_PROGRAMS`` (the 7pt and 27pt chains, both
factoring knobs, advection-diffusion vx=2, a zero centre, an x-asymmetric
27pt set, a random 27-term set) at k = 1..4 on random padded blocks of
ragged interiors with the wrapper's x-chunk and x-chunks of 3 and 1
planes, fp32/bf16 storage x fp32/bf16 compute x Dirichlet 0/0.3 (each with
the whole-domain edge mask, an interior shard's and a mixed one) and
periodic, and on the special-value field, bitwise; then times it at
1024^3 fp32 (Dirichlet bc 0) forced on the 7pt chain and on the advection
program at k = 1..4 beside the 7pt compile-time instance of the same call,
with the wrapper's x-chunk and, where they differ, with those of
``wave_xchunk`` (from the instance's resident blocks) and ``_xchunk``
forced, each last launch held bitwise.
``--times`` runs only the timings. ``--root DIR`` imports the package from
checkout DIR instead (an A/B: run it on the parent's checkout, then on
this one, in one call); a checkout whose stream wrapper has no
``launch_instance`` is forced onto the generic instance through its
``stream_instance``.

    python3 scripts/torch_stream_probe.py --generic \
        --variants '[["base", []], ["v1", ["-DNAME=1"]]]' [--sass]

builds the stream source once per variant (a name and extra ``nvcc``
flags), prints its generic instances' registers and spills, and times the
generic instance forced on the 7pt chain and the advection program at k =
1..4 (1024^3 fp32, each launch held bitwise) beside the 7pt chain
instance, and at k = 4 over x-chunk counts; ``--sass`` adds the opcode
histogram of the fp32 k = 4 generic instance's main loop. One JSON line
per variant; compare variants only within one call.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = (os.path.abspath(sys.argv[sys.argv.index("--root") + 1]) if "--root" in sys.argv
        else os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from heat3d_tpu_torch.core.config import BoundaryCondition, GridConfig  # noqa: E402
from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps  # noqa: E402
from heat3d_tpu_torch.ops import _build  # noqa: E402
from heat3d_tpu_torch.ops import stencil_direct as sd  # noqa: E402
from heat3d_tpu_torch.ops import stencil_stream as ss  # noqa: E402
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded  # noqa: E402
from heat3d_tpu_torch.parallel.halo import exchange_halo  # noqa: E402
from heat3d_tpu_torch.utils.timing import time_fn  # noqa: E402


def say(**kw):
    print(json.dumps(kw), flush=True)


def taps_of(kind, n=8):
    g = GridConfig.cube(n)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


def kernel(up, taps, k, periodic=False, bcv=0.0, out=None):
    """The stream kernel (k = 1) or streamk at depth k on ``up``."""
    if k == 1:
        return ss.apply_taps_stream(up, taps, out=out)
    return ss.apply_taps_streamk(up, taps, k, periodic, bcv, out=out)


def plain(up, taps, k, periodic=False, bcv=0.0):
    if k == 1:
        return apply_taps_padded(up, taps)
    return ss.apply_taps_streamk_ref(up, taps, k, periodic, bcv)


def check(shapes, bad):
    n = 0
    for shape in shapes:
        base = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in ("7pt", "27pt"):
                taps = taps_of(kind)
                for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
                    bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
                    for k in (1, *ss.STREAMK_DEPTHS):
                        if k > min(shape):
                            continue
                        up = exchange_halo(u, bc, bcv, k)
                        got = kernel(up, taps, k, periodic, bcv)
                        want = plain(up, taps, k, periodic, bcv)
                        torch.cuda.synchronize()
                        n += 1
                        if not torch.equal(got, want):
                            bad.append([list(shape), str(dtype), kind, periodic, bcv, k,
                                        os.environ.get("HEAT3D_FACTOR_7PT"),
                                        os.environ.get("HEAT3D_FACTOR_Y")])
    return n


def generic_programs() -> dict:
    """(knobs, taps) of each program the ``--generic`` probe forces on the
    generic instance."""
    from heat3d_tpu_torch import eqn
    from heat3d_tpu_torch.core.config import MeshConfig, SolverConfig, StencilConfig

    adv = eqn.solver_taps(SolverConfig(
        grid=GridConfig.cube(16), stencil=StencilConfig(kind="7pt"),
        mesh=MeshConfig(shape=(1, 1, 1)), equation="advection-diffusion",
        eq_params=(("vx", 2.0),)))
    zc = taps_of("7pt")
    zc[1, 1, 1] = 0.0
    asym = taps_of("27pt")
    asym[0, 0, 0] *= 1.5
    asym[2, 1, 0] *= 0.7
    return {"7pt": ({}, taps_of("7pt")), "27pt": ({}, taps_of("27pt")),
            "f7": ({"HEAT3D_FACTOR_7PT": "1"}, taps_of("7pt")),
            "fy0": ({"HEAT3D_FACTOR_Y": "0"}, taps_of("27pt")),
            "advection": ({}, adv), "zero-centre": ({}, zc), "asym27": ({}, asym),
            "random27": ({}, np.random.default_rng(4).uniform(-0.1, 0.1, (3, 3, 3)))}


GENERIC_PROGRAMS = ("7pt", "27pt", "f7", "fy0", "advection", "zero-centre", "asym27",
                    "random27")
# interiors: extents below 2k+1, odd nz, y/z no multiple of the tiles
# (38 x 62 at k = 1 down to 24 x 56 at k = 4), several tiles each way
SHAPES = ((1, 1, 1), (2, 3, 5), (3, 9, 67), (4, 45, 130), (5, 77, 125), (33, 17, 129),
          (40, 70, 65), (6, 39, 127))
# Dirichlet edge masks: the whole domain, an interior shard's, a mixed one
EDGES = (ss.ALL_EDGES, (False,) * 6, (True, False, False, True, True, False))


def force(k, code, up, taps, periodic=False, bcv=0.0, out=None, edges=ss.ALL_EDGES,
          xchunk=None, cd=torch.float32):
    """Instance ``code`` at depth k; a checkout without ``launch_instance``
    takes it through its ``stream_instance`` (the wrapper's x-chunk)."""
    if hasattr(ss, "launch_instance"):
        return ss.launch_instance(k, code, up, taps, periodic, bcv, out=out, edges=edges,
                                  xchunk=xchunk, compute_dtype=cd)
    pick = ss.stream_instance
    ss.stream_instance = lambda t: code
    try:
        if k == 1:
            return ss.apply_taps_stream(up, taps, out=out, compute_dtype=cd)
        return ss.apply_taps_streamk(up, taps, k, periodic, bcv, out=out, edges=edges,
                                     compute_dtype=cd)
    finally:
        ss.stream_instance = pick


def plain_of(up, taps, k, periodic=False, bcv=0.0, edges=ss.ALL_EDGES, cd=torch.float32):
    if k == 1:
        return apply_taps_padded(up, taps, mehrstellen=False, compute_dtype=cd)
    return ss.apply_taps_streamk_ref(up, taps, k, periodic, bcv, edges, cd)


def same(got, want) -> bool:
    """``torch.equal``, NaN in the same cells counting as equal (a random
    program's mixed signs meet infinities of both signs)."""
    nan = want.isnan()
    return torch.equal(got.isnan(), nan) and torch.equal(got.masked_fill(nan, 0),
                                                         want.masked_fill(nan, 0))


def generic_bitwise(bad) -> int:
    """The ``--generic`` probe's bitwise battery (see the module docstring)."""
    from chip_smoke import _special_field

    progs = generic_programs()
    cds = (torch.float32, torch.bfloat16)
    rng = np.random.default_rng(11)
    n = 0
    for name in GENERIC_PROGRAMS:
        knobs, taps = progs[name]
        os.environ.update(knobs)
        for k in (1, *ss.STREAMK_DEPTHS):
            fields = [(shape, (None, 3, 1)) for shape in SHAPES]
            fields.append(((24, 33, 70), (None,)))
            for shape, chunks in fields:
                padded = tuple(m + 2 * k for m in shape)
                base = (_special_field(padded, 5) if shape == (24, 33, 70)
                        else rng.standard_normal(padded).astype(np.float32))
                for dtype in cds:
                    up = torch.from_numpy(base).cuda().to(dtype)
                    for cd in cds:
                        for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
                            masks = EDGES if (k > 1 and not periodic) else EDGES[:1]
                            for edges in masks:
                                want = plain_of(up, taps, k, periodic, bcv, edges, cd)
                                for chunk in chunks:
                                    got = force(k, ss.GENERIC, up, taps, periodic, bcv,
                                                edges=edges, xchunk=chunk, cd=cd)
                                    torch.cuda.synchronize()
                                    n += 1
                                    if not same(got, want):
                                        bad.append([name, k, list(shape), str(dtype), str(cd),
                                                    periodic, bcv, ss.edge_bits(edges), chunk])
        for key in knobs:
            del os.environ[key]
        say(program=name, terms=len(sd.emission_program(taps)), cases=n, mismatches=bad[:20])
    return n


def wave_chunk(k, shape, dtype=torch.float32):
    """``wave_xchunk`` of the generic instance at depth k over ``shape``
    from its resident blocks on this card."""
    lib = ss._lib()
    ty, tz = lib.heat3d_stream_tile_y(k, ss.GENERIC), lib.heat3d_stream_tile_z(k, ss.GENERIC)
    per_sm = ss.instance_resources(k, ss.GENERIC, dtype)["blocks_per_sm"]
    resident = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    return (sd.wave_xchunk(shape[0], -(-shape[1] // ty) * -(-shape[2] // tz), resident),
            sd._xchunk(shape, ty, tz))


def generic_times(ms, bad, sweep=False) -> dict:
    """The generic instance forced on the 7pt chain and the advection
    program at 1024^3 fp32 (Dirichlet bc 0) at k = 1..4 beside the 7pt
    compile-time instance, each last launch held bitwise; ``wave_xchunk``
    against ``_xchunk`` where they differ (``sweep``: at k = 4 over x-chunk
    counts too)."""
    progs = generic_programs()
    n = 1024
    u = torch.rand((n, n, n), device="cuda")
    out = torch.empty_like(u)
    times = {}
    chains = {"7pt": taps_of("7pt", n), "advection": progs["advection"][1]}
    for k in (1, *ss.STREAMK_DEPTHS):
        up = exchange_halo(u, BoundaryCondition.DIRICHLET, 0.0, k)
        row = {}
        for name, taps in chains.items():
            row[f"generic_{name}_ms"] = ms(lambda: force(k, ss.GENERIC, up, taps, out=out))
            if not torch.equal(out, plain_of(up, taps, k)):
                bad.append(["1024^3 generic", name, k])
        row["chain_7pt_ms"] = ms(lambda: force(k, 1, up, chains["7pt"], out=out))
        if not torch.equal(out, plain_of(up, chains["7pt"], k)):
            bad.append(["1024^3 chain", k])
        if hasattr(ss, "launch_instance"):
            wave, target = wave_chunk(k, (n, n, n))
            row["xchunks"] = {"wave_xchunk": wave, "_xchunk": target}
            for key, c in (("wave", wave), ("target", target)):
                if wave != target:
                    row[f"generic_7pt_{key}_ms"] = ms(lambda: ss.launch_instance(
                        k, ss.GENERIC, up, chains["7pt"], out=out, xchunk=c))
            if sweep and k == 4:
                row["generic_7pt_ms_by_chunks"] = {
                    c: ms(lambda: ss.launch_instance(k, ss.GENERIC, up, chains["7pt"],
                                                     out=out, xchunk=-(-n // c)))
                    for c in (3, 4, 6, 8, 12, 16, 24)}
            row["resources"] = ss.instance_resources(k, ss.GENERIC, torch.float32)
        times[f"k{k}"] = row
        del up
        torch.cuda.empty_cache()
    del u, out
    torch.cuda.empty_cache()
    return times


# stream_generic<float, 4, F32Math>, by its mangled name
GENERIC4_F32 = "stream_genericIfLi4ENS_7F32Math"


def generic(args) -> int:
    """The ``--generic`` probe (see the module docstring)."""
    def ms(fn):
        return min(time_fn(fn, warmup=2, iters=10)) * 1e3

    bad = []
    if "--variants" in args:
        base_flags = _build.source_flags
        for name, extra in json.loads(args[args.index("--variants") + 1]):
            _build.source_flags = (lambda nm, e=tuple(extra):
                                   base_flags(nm) + (e if nm == "stencil_stream" else ()))
            _build.load.cache_clear()
            ss._lib.cache_clear()
            t0 = time.perf_counter()
            _build.build_all(["stencil_stream"])
            row = {"flags": extra, "build_s": time.perf_counter() - t0,
                   "ptxas": {k[-60:]: v for k, v in _build.ptxas_report("stencil_stream").items()
                             if "generic" in k},
                   "ms_1024": generic_times(ms, bad, sweep=True)}
            if "--sass" in args:
                from torch_direct_probe import loop_histogram

                row["sass"] = loop_histogram(str(_build._target("stencil_stream")),
                                             GENERIC4_F32)
            say(**{name: row})
        _build.source_flags = base_flags
        say(mismatches=bad)
        return 1 if bad else 0
    say(root=ROOT, build_seconds=_build.build_all(["stencil_stream"]))
    say(ptxas={k: v for k, v in _build.ptxas_report("stencil_stream").items() if "generic" in k})
    cds = (torch.float32, torch.bfloat16)
    say(generic_instances={f"k{k}_{str(d)[6:]}_c{str(c)[6:]}":
                           ss.instance_resources(k, ss.GENERIC, d, c)
                           for k in (1, *ss.STREAMK_DEPTHS) for d in cds for c in cds})
    n = 0 if "--times" in args else generic_bitwise(bad)
    say(generic_ms_1024=generic_times(ms, bad), mismatches=bad, cases=n,
        device=torch.cuda.get_device_name(0))
    return 1 if bad else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stream_probe: no CUDA device", file=sys.stderr)
        return 1
    say(nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    if "--generic" in sys.argv:
        return generic(sys.argv[1:])
    t0 = time.perf_counter()
    say(build_seconds=_build.build_all(["stencil_stream", "stencil_direct"]))
    for line in _build.build_log("stencil_stream").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip(), flush=True)
    say(instances={f"k{k}_{code}_{str(d)[6:]}": ss.instance_resources(k, code, d)
                   for k in (1, *ss.STREAMK_DEPTHS) for code in (ss.GENERIC, *ss.CHAINS)
                   for d in (torch.float32, torch.bfloat16)})
    bad = []
    n = check([(4, 4, 4), (3, 9, 67), (33, 17, 129), (40, 70, 65), (128, 128, 128),
               (5, 61, 131)], bad)
    for knobs in ({"HEAT3D_FACTOR_7PT": "1"}, {"HEAT3D_FACTOR_Y": "0"}):
        os.environ.update(knobs)
        n += check([(128, 128, 128)], bad)
        for key in knobs:
            del os.environ[key]
    say(bitwise_cases=n, mismatches=bad, generic_launches=ss.generic_launch_counts())

    def ms(fn):
        return min(time_fn(fn, warmup=2, iters=10)) * 1e3

    n, times = 1024, {}
    for kind, dtype in (("7pt", torch.float32), ("27pt", torch.float32),
                        ("7pt", torch.bfloat16)):
        taps = taps_of(kind, n)
        u = torch.rand((n, n, n), device="cuda").to(dtype)
        out = torch.empty_like(u)
        if (kind, dtype) == ("7pt", torch.float32):
            times["direct1"] = ms(lambda: sd.apply_taps_direct(u, taps, out=out))
            times["direct2"] = ms(lambda: sd.apply_taps_direct2(u, taps, out=out))
        ks = (1, *ss.STREAMK_DEPTHS) if (kind, dtype) == ("7pt", torch.float32) else (1, 4)
        for k in ks:
            up = exchange_halo(u, BoundaryCondition.DIRICHLET, 0.0, k)
            times[f"{kind}_{str(dtype)[6:]}_k{k}"] = ms(lambda: kernel(up, taps, k, out=out))
            del up
            torch.cuda.empty_cache()
        del u, out
        torch.cuda.empty_cache()
    say(ms_1024=times, device=torch.cuda.get_device_name(0),
        seconds=time.perf_counter() - t0)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
