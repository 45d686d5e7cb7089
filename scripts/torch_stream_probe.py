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
"""

import json
import os
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stream_probe: no CUDA device", file=sys.stderr)
        return 1
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
