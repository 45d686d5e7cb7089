#!/usr/bin/env python3
"""Short on-card probe of the fused kernels' generic instance
(``fused_generic<T, H, M>``, csrc/stencil_fused.cu).

    python3 scripts/torch_fused_probe.py [--times] [--root DIR]

Needs one CUDA GPU. Builds the fused source, prints the compiler's
registers and spills of every fused instance and the generic instance's
shared memory and resident blocks per SM (one and two updates x fp32/bf16
storage x both compute policies), holds the generic instance forced
(``fd.launch_instance(0, ...)``) bitwise against the plain version on each
program of ``PROGRAMS`` (the 7pt and 27pt chains, advection-diffusion
vx=2, a zero centre, an x-asymmetric 27pt set, a random 27-term set; NaN in
the same cells) over ``MESHES`` (the DMA and RDMA wrappers; one update
only on the 3D mesh) x fp32/bf16 storage x fp32/bf16 compute x Dirichlet
0.3/periodic, and over (8,1,1) on the special-value field; then times it
at 1024^3 fp32 (Dirichlet bc 0, every shard on the card in one launch:
the DMA kernels over (8,1,1), the RDMA ones over (4,1,1) with the
partitioned plan's ranges) forced on the 7pt chain and on the advection
program beside the 7pt compile-time instance of the same call, each last
launch held bitwise. ``--times`` runs only the timings. ``--root DIR``
imports the package from checkout DIR instead (an A/B: the parent's
checkout and this one in turns, in one call).

    python3 scripts/torch_fused_probe.py --variants '[["base", []], ["v1", ["-DNAME=1"]]]'

builds the fused source once per variant (a name and extra ``nvcc``
flags), prints its generic instances' registers and spills and times them
as above. One JSON line per part; compare variants only within one call.
"""

import itertools
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

from heat3d_tpu_torch.core.config import GridConfig  # noqa: E402
from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps  # noqa: E402
from heat3d_tpu_torch.ops import _build  # noqa: E402
from heat3d_tpu_torch.ops import stencil_dma_fused as fd  # noqa: E402
from heat3d_tpu_torch.ops import stencil_fused_rdma as fr  # noqa: E402
from heat3d_tpu_torch.parallel.topology import ShardMesh  # noqa: E402
from heat3d_tpu_torch.utils.timing import time_fn  # noqa: E402

GENERIC = 0
PROGRAMS = ("7pt", "27pt", "advection", "zero-centre", "asym27", "random27")
# (mesh, global field, send ranges a face): an x-slab, (4,1,1) with three
# ranges, the 3D route's (2,2,2) and a ragged, odd ny*nz over (2,1,1)
MESHES = (((8, 1, 1), (64, 40, 70), 1), ((4, 1, 1), (16, 20, 70), 3),
          ((2, 2, 2), (12, 20, 70), 1), ((2, 1, 1), (8, 77, 125), 1))


def say(**kw):
    print(json.dumps(kw), flush=True)


def taps_of(kind, n=8):
    g = GridConfig.cube(n)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


def programs(n=8) -> dict:
    from heat3d_tpu_torch import eqn
    from heat3d_tpu_torch.core.config import MeshConfig, SolverConfig, StencilConfig

    adv = eqn.solver_taps(SolverConfig(
        grid=GridConfig.cube(n), stencil=StencilConfig(kind="7pt"),
        mesh=MeshConfig(shape=(1, 1, 1)), equation="advection-diffusion",
        eq_params=(("vx", 2.0),)))
    zc = taps_of("7pt", n)
    zc[1, 1, 1] = 0.0
    asym = taps_of("27pt", n)
    asym[0, 0, 0] *= 1.5
    asym[2, 1, 0] *= 0.7
    return {"7pt": taps_of("7pt", n), "27pt": taps_of("27pt", n), "advection": adv,
            "zero-centre": zc, "asym27": asym,
            "random27": np.random.default_rng(4).uniform(-0.1, 0.1, (3, 3, 3))}


def card_mesh(shape, local):
    return ShardMesh(shape, local, [torch.device("cuda", 0)] * int(np.prod(shape)))


def split(u, mesh):
    return [u[tuple(slice(o, o + m) for o, m in zip(s.origin, mesh.local_shape))].contiguous()
            for s in mesh.shards]


def plain(halo, us, taps, mesh, periodic=False, bcv=0.0, cd=torch.float32):
    ref = fd.reference_fused_step if halo == 1 else fd.reference_fused_superstep
    return ref(us, taps, mesh, periodic, bcv, compute_dtype=cd)


def same(got, want) -> bool:
    """``torch.equal``, NaN in the same cells counting as equal."""
    nan = want.isnan()
    return torch.equal(got.isnan(), nan) and torch.equal(got.masked_fill(nan, 0),
                                                         want.masked_fill(nan, 0))


def bitwise(bad) -> int:
    """The bitwise battery (see the module docstring)."""
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import _special_field

    progs = programs()
    cds = (torch.float32, torch.bfloat16)
    fields = [(m, parts, np.random.default_rng(24).standard_normal(shape).astype(np.float32),
               dtype) for m, shape, parts in MESHES for dtype in cds]
    fields.append(((8, 1, 1), 1, _special_field((64, 40, 70), 15), torch.float32))
    n = 0
    for mesh_shape, parts, base, dtype in fields:
        local = tuple(g // p for g, p in zip(base.shape, mesh_shape))
        mesh = card_mesh(mesh_shape, local)
        us = split(torch.from_numpy(base).cuda().to(dtype), mesh)
        slab = mesh_shape[1] == mesh_shape[2] == 1
        bounds = partition_bounds(local[1], parts) if parts > 1 else None
        for name, halo, cd, (periodic, bcv) in itertools.product(
                PROGRAMS, (1, 2) if slab else (1,), cds, ((False, 0.3), (True, 0.0))):
            taps = progs[name]
            want = plain(halo, us, taps, mesh, periodic, bcv, cd)
            for wrapper in (fd.KERNELS[halo - 1], fr.KERNELS[halo - 1])[:1 + slab]:
                state = fd.FusedState(mesh, halo, dtype, periodic, bounds)
                got = fd.launch_instance(GENERIC, us, taps, mesh, state, periodic, bcv,
                                         wrapper=wrapper, compute_dtype=cd)
                torch.cuda.synchronize()
                fd.raise_if_timed_out()
                n += 1
                if not all(same(g, w) for g, w in zip(got, want)):
                    bad.append([name, list(mesh_shape), list(base.shape), str(dtype), str(cd),
                                halo, periodic, wrapper.__name__])
        del us
        torch.cuda.empty_cache()
    say(bitwise_cases=n, mismatches=bad[:20])
    return n


def times(ms, bad, sweep=False) -> dict:
    """1024^3 fp32 per wrapper: the 7pt compile-time instance and the
    generic instance forced on the 7pt chain and on the advection program,
    each last launch held bitwise; ``sweep``: the generic instance on the
    7pt chain also at 1 to 12 interior x-chunks a shard."""
    from heat3d_tpu_torch.parallel.plan import DEFAULT_PART_MIN_BYTES, Schedule

    n = 1024
    chains = {"7pt": taps_of("7pt", n), "advection": programs(n)["advection"]}
    out = {}
    for wrapper, mesh_shape in ((fd.apply_step_fused_dma, (8, 1, 1)),
                                (fd.apply_superstep_fused_dma, (8, 1, 1)),
                                (fr.apply_step_fused_rdma, (4, 1, 1)),
                                (fr.apply_superstep_fused_rdma, (4, 1, 1))):
        halo = 2 if "superstep" in wrapper.__name__ else 1
        mesh = card_mesh(mesh_shape, tuple(n // p for p in mesh_shape))
        us = [torch.rand(mesh.local_shape, device="cuda") for _ in mesh.shards]
        outs = [torch.empty_like(u) for u in us]
        bounds = None
        if wrapper in fr.KERNELS:
            sched = Schedule(mesh.shape, halo, "partitioned",
                             min_part_bytes=DEFAULT_PART_MIN_BYTES)
            bounds = fr.plan_send_bounds(sched, mesh.local_shape, 4)
        state = fd.FusedState(mesh, halo, torch.float32, False, bounds)

        def go(inst, taps, xchunk=None):
            mesh.fork()
            fd.launch_instance(inst, us, taps, mesh, state, False, 0.0, outs=outs,
                               wrapper=wrapper, xchunk=xchunk)
            mesh.join()

        row = {"mesh": list(mesh_shape), "send_ranges": [list(b) for b in state.bounds]}
        for key, inst, taps in (("chain_7pt_ms", fd.fused_instance(halo, chains["7pt"]),
                                 chains["7pt"]),
                                ("generic_7pt_ms", GENERIC, chains["7pt"]),
                                ("generic_advection_ms", GENERIC, chains["advection"])):
            row[key] = ms(lambda: go(inst, taps))
            want = plain(halo, us, taps, mesh)
            if not all(torch.equal(g, w) for g, w in zip(outs, want)):
                bad.append(["1024^3", wrapper.__name__, key])
            del want
        row["generic_over_chain"] = row["generic_7pt_ms"] / row["chain_7pt_ms"]
        if sweep:
            inner = mesh.local_shape[0] - 2 * halo
            row["generic_7pt_ms_by_xchunks"] = {
                c: ms(lambda: go(GENERIC, chains["7pt"], -(-inner // c)))
                for c in (1, 2, 3, 4, 6, 8, 12)}
        if hasattr(fd, "wave_xchunk"):
            row["xchunk"] = fd._launch_xchunk(halo, GENERIC, tuple(mesh.local_shape), len(mesh),
                                              0, torch.float32)
        out[wrapper.__name__] = row
        del us, outs, state
        torch.cuda.empty_cache()
    return out


def resources() -> dict:
    cds = (torch.float32, torch.bfloat16)
    return {f"h{h}_{str(d)[6:]}_c{str(c)[6:]}": fd.instance_resources(h, GENERIC, d, c)
            for h in (1, 2) for d in cds for c in cds}


def ptxas() -> dict:
    return {k[-80:]: v for k, v in _build.ptxas_report("stencil_fused").items()}


def frames() -> list:
    """The compiler's stack-frame lines of the generic instances."""
    lines, entry = [], ""
    for line in _build.build_log("stencil_fused").splitlines():
        if "Compiling entry" in line:
            entry = line
        elif "stack frame" in line and "generic" in entry:
            lines.append(entry.split("'")[1][-60:] + ": " + line.strip())
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fused_probe: no CUDA device", file=sys.stderr)
        return 1
    say(nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), root=ROOT)

    def ms(fn):
        return min(time_fn(fn, warmup=2, iters=10)) * 1e3

    args = sys.argv[1:]
    bad = []
    if "--variants" in args:
        base_flags = _build.source_flags
        for name, extra in json.loads(args[args.index("--variants") + 1]):
            _build.source_flags = (lambda nm, e=tuple(extra):
                                   base_flags(nm) + (e if nm == "stencil_fused" else ()))
            _build.load.cache_clear()
            fd._lib.cache_clear()
            fd._launch_xchunk.cache_clear()
            t0 = time.perf_counter()
            _build.build_all(["stencil_fused"])
            say(**{name: {"flags": extra, "build_s": time.perf_counter() - t0,
                          "ptxas": {k: v for k, v in ptxas().items() if "generic" in k},
                          "resources": resources(), "ms_1024": times(ms, bad, sweep=True)}})
        _build.source_flags = base_flags
        say(mismatches=bad)
        return 1 if bad else 0
    t0 = time.perf_counter()
    say(build_seconds=_build.build_all(["stencil_fused"]), ptxas=ptxas(), frames=frames())
    say(generic_instances=resources())
    n = 0 if "--times" in args else bitwise(bad)
    say(ms_1024=times(ms, bad), mismatches=bad, cases=n,
        device=torch.cuda.get_device_name(0), seconds=time.perf_counter() - t0)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
