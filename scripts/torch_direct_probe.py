#!/usr/bin/env python3
"""Short on-card probe of the port's direct kernels (csrc/stencil_direct.cu).

    python3 scripts/torch_direct_probe.py

Needs one CUDA GPU. Builds the direct kernel source, prints the compiler's
register and spill report of every direct instance and each instance's
shared memory, registers and resident blocks per SM, holds direct1 and
direct2 bitwise against their plain versions at ragged shapes (odd nz, y
and z no multiple of the tile, nx below 2H+1, forced x-chunks; 7pt/27pt x
fp32/bf16 x Dirichlet 0/0.3/periodic), each launch on the instance
``stream_instance`` names, and under the factoring knobs at 128^3 (the
generic instance), then times both at 1024^3 (7pt fp32, 27pt fp32, 7pt bf16)
beside the generic instance forced on the 7pt chain and the stream kernels
of the same call, and over x-chunk counts (7pt fp32) beside the count the
wrapper picks (``wave_xchunk``). The Mehrstellen instance
(``HEAT3D_MEHRSTELLEN=1``, 27pt) is held bitwise at the same ragged shapes
and timed at 1024^3 (fp32, bf16) beside the 27pt chain instance of the same
call, with its x-chunk sweep. Prints one JSON line per part. About a minute
on an H100: the first call after a kernel change, before ``chip_smoke.py``.

    python3 scripts/torch_direct_probe.py --mehrstellen-only

builds only the direct source and runs only the 27pt parts (the
Mehrstellen checks, and both instances' 1024^3 times and sweep): the probe
of a variant of the Mehrstellen instance.

    python3 scripts/torch_direct_probe.py --generic

builds only the direct source, prints the generic instance's registers,
spills, shared memory and blocks per SM (fp32/bf16 storage x both compute
policies), holds it forced on each program of ``GENERIC_PROGRAMS`` (the
7pt and 27pt chains, both factoring knobs, advection-diffusion vx=2, a zero
centre, an x-asymmetric 27pt set, a random 27-term set) at the ragged
shapes with forced x-chunks, fp32/bf16 storage x fp32/bf16 compute x
Dirichlet 0/0.3/periodic, and on the special-value field, bitwise; then
times it at 1024^3 (Dirichlet bc 0) on the 7pt, advection, 27pt and
random programs beside the compile-time instance of the same call where
the chain has one, each launch held bitwise: the probe of a change to the
generic instance.

    python3 scripts/torch_direct_probe.py \\
        --variants '[["base", []], ["v1", ["-DNAME=1"]]]' [--all] [--sass]

builds the direct source once per variant (a name and extra ``nvcc`` flags,
e.g. ``-D`` switches a source under study reads), prints its two-update
instances' registers and spills, and times at 1024^3 (27pt, Dirichlet bc
0) the Mehrstellen two-update instance in fp32 and bf16 compute beside the
27pt chain instance, each held bitwise to its plain version; ``--all``
adds the 27pt chain in bf16 compute and the 7pt direct2 in fp32 and bf16
compute; ``--sass`` adds the opcode
histogram of the Mehrstellen two-update instance's main loop (the longest
backward branch of ``cuobjdump -sass``: what a step issues); ``--generic``
times instead the generic instance forced on the 7pt chain and the
advection program at halo 1 and 2 beside the 7pt chain instance (fp32,
each launch checked bitwise), with the generic instances' registers and
spills, and ``--sass`` then reads the generic two-update instance. One
JSON line per variant; compare variants only within one call.
"""

import collections
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heat3d_tpu_torch.core.config import BoundaryCondition, GridConfig  # noqa: E402
from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps  # noqa: E402
from heat3d_tpu_torch.ops import _build  # noqa: E402
from heat3d_tpu_torch.ops import stencil_direct as sd  # noqa: E402
from heat3d_tpu_torch.ops import stencil_stream as ss  # noqa: E402
from heat3d_tpu_torch.parallel.halo import exchange_halo  # noqa: E402
from heat3d_tpu_torch.utils.timing import time_fn  # noqa: E402

# ragged shapes: nx below 2H+1, odd nz, y/z extents no multiple of the
# tiles (38 x 62 at halo 1, 28 x 60 at halo 2), several tiles each way
SHAPES = ((1, 1, 1), (2, 3, 5), (3, 9, 67), (4, 45, 130), (5, 77, 125), (33, 17, 129),
          (40, 70, 65), (6, 39, 127))
# forced x-chunks of the multi-chunk cases
CHUNKS = (None, 2, 3)


def say(**kw):
    print(json.dumps(kw), flush=True)


def taps_of(kind, n=8):
    g = GridConfig.cube(n)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


def check(shapes, chunks, bad):
    """Every direct launch at ``shapes`` bitwise against its plain version,
    on the instance ``stream_instance`` names (counted by the wrapper);
    a chunk of ``None`` takes the wrapper's x-chunk, else that many planes."""
    n = 0
    kinds = ("27pt",) if os.environ.get("HEAT3D_MEHRSTELLEN") else ("7pt", "27pt")
    for shape in shapes:
        base = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in kinds:
                taps = taps_of(kind)
                code = ss.stream_instance(taps)
                mehr = sd.direct_instance(taps) == sd.MEHRSTELLEN
                for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
                    for halo, kern, plain in ((1, sd.apply_taps_direct, sd.apply_taps_direct_ref),
                                              (2, sd.apply_taps_direct2,
                                               sd.apply_taps_direct2_ref)):
                        for chunk in chunks:
                            before = sd.generic_launch_counts()[kern.__name__]
                            before_m = sd.mehrstellen_launch_counts()[kern.__name__]
                            if chunk is None:
                                got = kern(u, taps, periodic, bcv)
                            else:
                                got = sd.launch_instance(halo, sd.direct_instance(taps), u, taps,
                                                         periodic, bcv, xchunk=chunk)
                            want = plain(u, taps, periodic, bcv)
                            torch.cuda.synchronize()
                            took = sd.generic_launch_counts()[kern.__name__] - before
                            took_m = sd.mehrstellen_launch_counts()[kern.__name__] - before_m
                            n += 1
                            if (not torch.equal(got, want) or took != (code == ss.GENERIC)
                                    or took_m != mehr):
                                err = float((got.float() - want.float()).abs().max())
                                bad.append([list(shape), str(dtype), kind, periodic, bcv, halo,
                                            chunk, code, took, err,
                                            os.environ.get("HEAT3D_FACTOR_7PT"),
                                            os.environ.get("HEAT3D_FACTOR_Y")])
    return n


def chunk_sweep(ms, kind="7pt") -> dict:
    """direct1 and direct2 at 1024^3 fp32 over x-chunk counts on the
    instance ``kind`` takes under the current knobs: ms per launch at each
    count, and the count the wrapper picks."""
    n = 1024
    taps = taps_of(kind, n)
    u = torch.rand((n, n, n), device="cuda")
    out = torch.empty_like(u)
    res = {}
    for halo in (1, 2):
        code = sd.direct_instance(taps)
        pick = -(-n // sd._launch_xchunk(tuple(u.shape), halo, code, u.device.index, u.dtype))
        sweep = {}
        for c in sorted({4, 7, 10, 13, 16, 20, 23, 24, 28, 32, pick}):
            x = -(-n // c)
            sweep[c] = ms(lambda: sd.launch_instance(halo, code, u, taps, out=out, xchunk=x))
        res[f"direct{halo}"] = {"wrapper_chunks": pick, "ms_by_chunks": sweep}
    del u, out
    torch.cuda.empty_cache()
    return res


def mehrstellen(ms, bad) -> int:
    """The Mehrstellen parts: the ragged shapes and 128^3 bitwise under the
    knob, then direct1 and direct2 at 1024^3 (27pt, Dirichlet bc 0) on the
    Mehrstellen instance (knob on) and on the chain instance (knob off),
    fp32 and bf16, each launch held bitwise to its plain version, and the
    Mehrstellen instance's x-chunk sweep (fp32)."""
    os.environ["HEAT3D_MEHRSTELLEN"] = "1"
    sd.reset_launch_counts()
    n = check(SHAPES, CHUNKS, bad)
    n += check([(128, 128, 128)], (None,), bad)
    say(mehrstellen_bitwise_cases=n, mismatches=bad,
        mehrstellen_launches=sd.mehrstellen_launch_counts())
    size, times = 1024, {}
    taps = taps_of("27pt", size)
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.rand((size, size, size), device="cuda").to(dtype)
        out = torch.empty_like(u)
        for route, knob in (("mehrstellen", "1"), ("chain", "0")):
            os.environ["HEAT3D_MEHRSTELLEN"] = knob
            for halo, kern, plain in ((1, sd.apply_taps_direct, sd.apply_taps_direct_ref),
                                      (2, sd.apply_taps_direct2, sd.apply_taps_direct2_ref)):
                key = f"direct{halo}_{route}_27pt_{str(dtype)[6:]}"
                times[key] = ms(lambda: kern(u, taps, out=out))
                if not torch.equal(out, plain(u, taps)):
                    bad.append(["1024^3", key])
        del u, out
        torch.cuda.empty_cache()
    os.environ["HEAT3D_MEHRSTELLEN"] = "1"
    say(mehrstellen_ms_1024=times, mismatches=bad,
        chunk_sweep_1024_mehrstellen_float32=chunk_sweep(ms, "27pt"))
    del os.environ["HEAT3D_MEHRSTELLEN"]
    return n


# direct_kernel<float, 2, SPEC_MEHR, F32Math>, by its mangled name
MEHR2_F32 = "direct_kernelIfLi2ELi3ENS_7F32Math"


def loop_histogram(so: str, fragment: str) -> dict:
    """Opcode counts of the longest loop of the kernel whose mangled name
    holds ``fragment``, from ``cuobjdump -sass``."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", so],
                          capture_output=True, text=True, timeout=600).stdout
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if fragment not in part.split("\n", 1)[0]:
            continue
        ins = []
        for line in part.split("\n"):
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                ins.append((int(m.group(1), 16),
                            re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())))
        index = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (a, text) in enumerate(ins):
            m = re.match(r"BRA\s+0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) <= a:  # a backward branch
                start = index[int(m.group(1), 16)]
                loops.append((i - start, start, i))
        if not loops:
            return {}
        n, start, end = max(loops)
        hist = collections.Counter(t.split()[0] for _, t in ins[start:end + 1])
        return {"loop_instructions": n + 1, "opcodes": dict(hist.most_common())}
    return {}


# direct_generic<float, 2, F32Math>, by its mangled name
GENERIC2_F32 = "direct_genericIfLi2ENS_7F32Math"


def variants(spec, every: bool, sass: bool, gen: bool = False) -> int:
    """The ``--variants`` probe (see the module docstring); ``gen``: the
    generic instance forced on the 7pt chain and the advection program at
    halo 1 and 2 (fp32) beside the 7pt chain instance, and the SASS of its
    two-update instance."""
    n = 1024
    u = torch.rand((n, n, n), device="cuda")
    out = torch.empty_like(u)
    base_flags = _build.source_flags
    cases = [("mehr2_f32", "1", torch.float32, "27pt"),
             ("mehr2_bf16c", "1", torch.bfloat16, "27pt"),
             ("chain27_2", "0", torch.float32, "27pt")]
    if every:
        cases += [("chain27_2_bf16c", "0", torch.bfloat16, "27pt"),
                  ("d2_7pt_f32", "0", torch.float32, "7pt"),
                  ("d2_7pt_bf16c", "0", torch.bfloat16, "7pt")]
    if gen:
        progs = generic_programs()
        cases = [(f"generic{h}_{name}", h, progs[name][1]) for h in (1, 2)
                 for name in ("7pt", "advection")]
        cases += [(f"chain{h}_7pt", h, None) for h in (1, 2)]
    bad = 0
    for name, extra in spec:
        _build.source_flags = (lambda nm, e=tuple(extra):
                               base_flags(nm) + (e if nm == "stencil_direct" else ()))
        _build.load.cache_clear()
        sd._lib.cache_clear()
        sd._launch_xchunk.cache_clear()
        t0 = time.perf_counter()
        _build.build_all(["stencil_direct"])
        row = {"flags": extra, "build_s": time.perf_counter() - t0,
               "ptxas": {k[-60:]: v for k, v in _build.ptxas_report("stencil_direct").items()
                         if "Li2ELi3E" in k}}
        if gen:
            row["ptxas"] = {k[-70:]: v for k, v in _build.ptxas_report("stencil_direct").items()
                            if "direct_generic" in k}
            for key, halo, taps in cases:
                code = ss.GENERIC if taps is not None else 1
                taps = taps if taps is not None else taps_of("7pt", n)
                ms = min(time_fn(lambda: sd.launch_instance(halo, code, u, taps, out=out),
                                 warmup=2, iters=10)) * 1e3
                same = torch.equal(out, PLAIN[halo](u, taps, False, 0.0))
                row[key] = {"ms": ms, "bitwise": same}
        for key, knob, cd, kind in ([] if gen else cases):
            os.environ["HEAT3D_MEHRSTELLEN"] = knob
            taps = taps_of(kind, n)
            ms = min(time_fn(lambda: sd.apply_taps_direct2(u, taps, out=out, compute_dtype=cd),
                             warmup=2, iters=10)) * 1e3
            same = torch.equal(out, sd.apply_taps_direct2_ref(u, taps, False, 0.0, cd))
            bad += not same
            row[key] = {"ms": ms, "bitwise": same}
        if sass:
            row["sass"] = loop_histogram(str(_build._target("stencil_direct")),
                                         GENERIC2_F32 if gen else MEHR2_F32)
        say(**{name: row})
    _build.source_flags = base_flags
    os.environ.pop("HEAT3D_MEHRSTELLEN", None)
    return 1 if bad else 0


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
PLAIN = {1: sd.apply_taps_direct_ref, 2: sd.apply_taps_direct2_ref}


def same(got, want) -> bool:
    """``torch.equal``, NaN in the same cells counting as equal (a random
    program's mixed signs meet infinities of both signs)."""
    nan = want.isnan()
    return torch.equal(got.isnan(), nan) and torch.equal(got.masked_fill(nan, 0),
                                                         want.masked_fill(nan, 0))


def generic(ms) -> int:
    """The ``--generic`` probe (see the module docstring)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import _special_field

    say(build_seconds=_build.build_all(["stencil_direct"]))
    say(ptxas={k: v for k, v in _build.ptxas_report("stencil_direct").items()
               if "direct_generic" in k})
    cds = (torch.float32, torch.bfloat16)
    say(generic_instances={f"h{h}_{str(d)[6:]}_c{str(c)[6:]}":
                           sd.instance_resources(h, ss.GENERIC, d, c)
                           for h in (1, 2) for d in cds for c in cds})
    progs = generic_programs()
    bad, n = [], 0
    for name in GENERIC_PROGRAMS:
        knobs, taps = progs[name]
        os.environ.update(knobs)
        fields = [(shape, np.random.default_rng(8).standard_normal(shape).astype(np.float32),
                   (None, 3, 1)) for shape in SHAPES]
        fields.append(((24, 33, 70), _special_field((24, 33, 70), 5), (None,)))
        for shape, base, chunks in fields:
            for dtype in cds:
                u = torch.from_numpy(base).cuda().to(dtype)
                for cd in cds:
                    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
                        for halo in (1, 2):
                            want = PLAIN[halo](u, taps, periodic, bcv, cd)
                            for chunk in chunks:
                                got = sd.launch_instance(halo, ss.GENERIC, u, taps, periodic,
                                                         bcv, xchunk=chunk, compute_dtype=cd)
                                torch.cuda.synchronize()
                                n += 1
                                if not same(got, want):
                                    bad.append([name, list(shape), str(dtype), str(cd),
                                                periodic, bcv, halo, chunk])
        for key in knobs:
            del os.environ[key]
        say(program=name, terms=len(sd.emission_program(taps)), cases=n, mismatches=bad[:20])
    size, times = 1024, {}
    u = torch.rand((size,) * 3, device="cuda")
    out = torch.empty_like(u)
    for name in ("7pt", "advection", "27pt", "random27"):
        taps = progs[name][1]
        code = sd.direct_instance(taps)
        for halo in (1, 2):
            for cd in cds:
                key = f"direct{halo}_{name}_c{str(cd)[6:]}"
                times[key] = {"generic_ms": ms(lambda: sd.launch_instance(
                    halo, ss.GENERIC, u, taps, out=out, compute_dtype=cd))}
                if not torch.equal(out, PLAIN[halo](u, taps, False, 0.0, cd)):
                    bad.append(["1024^3 generic", key])
                if code != ss.GENERIC:
                    times[key]["chain_ms"] = ms(lambda: sd.launch_instance(
                        halo, code, u, taps, out=out, compute_dtype=cd))
    say(generic_ms_1024=times, mismatches=bad, cases=n,
        device=torch.cuda.get_device_name(0))
    return 1 if bad else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_direct_probe: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    only = "--mehrstellen-only" in args
    t0 = time.perf_counter()
    say(nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    if "--generic" in args and "--variants" not in args:
        return generic(lambda fn: min(time_fn(fn, warmup=2, iters=10)) * 1e3)
    if "--variants" in args:
        return variants(json.loads(args[args.index("--variants") + 1]), "--all" in args,
                        "--sass" in args, "--generic" in args)
    say(build_seconds=_build.build_all(["stencil_direct"] if only
                                       else ["stencil_direct", "stencil_stream"]))
    say(ptxas={k: v for k, v in _build.ptxas_report("stencil_direct").items()})
    say(instances={f"h{h}_{code}_{str(d)[6:]}": sd.instance_resources(h, code, d)
                   for h in (1, 2) for code in (ss.GENERIC, *ss.CHAINS, sd.MEHRSTELLEN)
                   for d in (torch.float32, torch.bfloat16)})

    def ms(fn):
        return min(time_fn(fn, warmup=2, iters=10)) * 1e3

    bad = []
    mehrstellen(ms, bad)
    if only:
        say(seconds=time.perf_counter() - t0)
        return 1 if bad else 0
    n = check(SHAPES, CHUNKS, bad)
    n += check([(128, 128, 128)], (None,), bad)
    for knobs in ({"HEAT3D_FACTOR_7PT": "1"}, {"HEAT3D_FACTOR_Y": "0"},
                  {"HEAT3D_FACTOR_7PT": "1", "HEAT3D_FACTOR_Y": "0"}):
        os.environ.update(knobs)
        n += check([(128, 128, 128), (5, 77, 125)], (None,), bad)
        for key in knobs:
            del os.environ[key]
    say(bitwise_cases=n, mismatches=bad, generic_launches=sd.generic_launch_counts())

    n, times = 1024, {}
    for kind, dtype in (("7pt", torch.float32), ("27pt", torch.float32),
                        ("7pt", torch.bfloat16)):
        taps = taps_of(kind, n)
        u = torch.rand((n, n, n), device="cuda").to(dtype)
        out = torch.empty_like(u)
        tag = f"{kind}_{str(dtype)[6:]}"
        for halo, kern, plain in ((1, sd.apply_taps_direct, sd.apply_taps_direct_ref),
                                  (2, sd.apply_taps_direct2, sd.apply_taps_direct2_ref)):
            times[f"direct{halo}_{tag}"] = ms(lambda: kern(u, taps, out=out))
            ok = torch.equal(out, plain(u, taps))
            if not ok:
                bad.append(["1024^3", tag, halo])
            if (kind, dtype) == ("7pt", torch.float32):
                times[f"direct{halo}_generic_{tag}"] = ms(
                    lambda: sd.launch_instance(halo, ss.GENERIC, u, taps, out=out))
        if (kind, dtype) == ("7pt", torch.float32):
            for k in (1, 2):
                up = exchange_halo(u, BoundaryCondition.DIRICHLET, 0.0, k)
                times[f"stream_k{k}_{tag}"] = ms(
                    lambda: (ss.apply_taps_stream(up, taps, out=out) if k == 1
                             else ss.apply_taps_streamk(up, taps, k, out=out)))
                del up
                torch.cuda.empty_cache()
        del u, out
        torch.cuda.empty_cache()
    say(ms_1024=times, device=torch.cuda.get_device_name(0), mismatches=bad,
        seconds=time.perf_counter() - t0)
    say(chunk_sweep_1024_7pt_float32=chunk_sweep(ms), seconds=time.perf_counter() - t0)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
