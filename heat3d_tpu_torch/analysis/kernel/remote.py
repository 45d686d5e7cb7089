"""Family kernel-remote: every ghost lands from the neighbour the plan names.

The counterpart of the JAX kernel tier's remote-target proof (ANL1031–
1033): there every ``make_async_remote_copy`` target is held to the ±1
neighbour bijection ``shift_perm`` builds; here each multi-shard case (the
DMA exchange, the fused DMA and RDMA kernels) runs on shards stamped with
their rank + 1 everywhere, and what lands is held to the global field:

- ANL1031: a DMA ghost region (offset ``(ox, oy, oz)`` of a shard's padded
  block) or a fused kernel's face output holds another shard's stamp than
  the neighbour's (the message names the shard it came from, and the one
  the mesh names);
- ANL1032: a ghost region holds no shard's stamp and not the bc (garbage);
- ANL1033: the mesh's neighbour (``ShardMesh.neighbor``, which the
  exchange plan walks) disagrees with ``topology.shift_perm``, the ring
  the JAX package's ``ppermute`` pairs are built from.

The reference is independent of the exchange's neighbour logic: the
shards stitched into the global field by their origins, its padded block
(DMA) or its plain updates (fused) cut back by origin. On the CPU the
plain versions run.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import torch

from heat3d_tpu_torch.analysis.findings import ERROR, Finding

CHECKER = "kernel-remote"
_PATH = "heat3d_tpu_torch/analysis/kernel/remote.py"


def _neighbour_findings(case, mesh) -> List[tuple]:
    from heat3d_tpu_torch.parallel.topology import shift_perm

    out = []
    for axis in range(3):
        n = mesh.shape[axis]
        for d in (-1, +1):
            # shift_perm(n, -d) sends i to i-d: the shard a ghost on side d
            # comes from is the source of that pair
            src_of = {dst: src for src, dst in shift_perm(n, -d, case.periodic)}
            for s in mesh.shards:
                nb = mesh.neighbor(s, axis, d, case.periodic)
                want = src_of.get(s.coords[axis])
                got = None if nb is None else nb.coords[axis]
                if got != want:
                    out.append(("ANL1033", f"shard {s.rank} axis {axis} side {d:+d}: the mesh "
                                f"names coordinate {got}, shift_perm {want}"))
    return out


def _region(w: int, n: int, o: int):
    return slice(0, w) if o < 0 else (slice(w + n, w + n + w) if o > 0 else slice(w, w + n))


def _label(v: float, case) -> str:
    if abs(v - case.bc) < 1e-6 and not case.periodic:
        return "the bc"
    r = round(v) - 1
    return f"shard {r}" if abs(v - (r + 1)) < 1e-6 and r >= 0 else f"value {v:g}"


def _dma_findings(case, run, got, want) -> List[tuple]:
    out = []
    w = case.depth
    for s, g, r in zip(run.mesh.local_shards, got, want):
        for off in itertools.product((-1, 0, 1), repeat=3):
            if off == (0, 0, 0):
                continue
            sl = tuple(_region(w, n, o) for n, o in zip(case.local, off))
            gr, rr = g[sl].float(), r[sl].float()
            if torch.equal(gr, rr):
                continue
            vals = sorted({float(v) for v in torch.unique(gr).cpu()})
            code = "ANL1031" if all(_label(v, case).startswith(("shard", "the bc"))
                                    for v in vals) else "ANL1032"
            out.append((code, f"shard {s.rank} ghost region {off}: holds "
                        f"{', '.join(_label(v, case) for v in vals[:4])}; wants "
                        f"{_label(float(rr.flatten()[0]), case)}"))
    return out


def _fused_findings(case, run, got, want) -> List[tuple]:
    out = []
    h = case.depth
    tol = 1e-5 if case.storage == "float32" and case.compute == "float32" else 2e-2
    for s, g, r in zip(run.mesh.local_shards, got, want):
        diff = (g.float() - r.float()).abs()
        lim = tol * max(1.0, float(r.float().abs().max()))
        if float(diff.max()) <= lim:
            continue
        mine = []
        for side, sl in (("low", slice(0, h)), ("high", slice(-h, None))):
            if float(diff[sl].max()) > lim:
                nb = run.mesh.neighbor(s, 0, -1 if side == "low" else +1, case.periodic)
                mine.append(("ANL1031", f"shard {s.rank} {side} x face: the output differs "
                             f"from the global solve by {float(diff[sl].max()):.3g} — its "
                             f"ghosts did not land from "
                             f"{'the bc' if nb is None else f'shard {nb.rank}'}"))
        out += mine or [("ANL1032", f"shard {s.rank}: the output differs from the global "
                         f"solve by {float(diff.max()):.3g} away from the x faces")]
    return out


def check(cases: Sequence, device, report: Dict) -> List[Finding]:
    from heat3d_tpu_torch.analysis.kernel.cases import Run

    findings: List[Finding] = []
    verdicts = report.setdefault("verdicts", {}).setdefault(CHECKER, {})
    for case in cases:
        if not case.multi:
            continue  # one shard: its only neighbour is itself
        problems = []
        try:
            run = Run(case, device, stamp=True)
            problems += _neighbour_findings(case, run.mesh)
            got = run.launch()
            want = run.reference()
            if run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
            problems += (_dma_findings if case.family == "dma" else _fused_findings)(
                case, run, got, want)
        except Exception as e:  # noqa: BLE001 - a case that cannot run is a finding
            problems.append(("ANL1032", f"the case did not run: {type(e).__name__}: "
                             f"{' '.join(str(e).split())[:200]}"))
        verdicts[case.key] = "error" if problems else "clean"
        for code, message in problems:
            findings.append(Finding(
                checker=CHECKER, severity=ERROR, path=_PATH, line=0, code=code,
                symbol=f"{case.key}|{code}",
                message=f"{case.key} (row {case.row}, {case.wrapper}) on {device}: {message}",
            ))
    return findings
