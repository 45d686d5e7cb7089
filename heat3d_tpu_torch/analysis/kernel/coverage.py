"""Family kernel-coverage: every output cell written, nothing outside it.

Each case's output buffers (a DMA case: its padded blocks, where the
ghosts land; a fused case on a card: also its state's landing buffers,
where the neighbours' faces land) are cut from the middle of a larger
allocation, and the whole allocation is filled with a NaN sentinel before
one launch. After it, every output and landing cell must hold a number
(the inputs are finite: a NaN left over is a cell no thread wrote —
ANL1021; a landing buffer no neighbour feeds, at a Dirichlet x face, is
exempt) and every guard-band cell must still hold the sentinel (a number
there is a store past the buffer — ANL1022). A case that fails to launch
is ANL1023. The counterpart of the JAX kernel tier's index-map coverage
proof (ANL1021–1023), made by running the kernel instead of interpreting
it; on the CPU it runs the plain versions (the same buffers, the
wrappers' ``out=`` path).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from heat3d_tpu_torch.analysis.findings import ERROR, Finding

CHECKER = "kernel-coverage"
_PATH = "heat3d_tpu_torch/analysis/kernel/coverage.py"
# guard cells on each side of a buffer: a multiple of 128 elements keeps
# the buffer's alignment (the kernels move rows as aligned vectors)
GUARD = 256


class Guarded:
    """Allocations bounded by guard bands, every cell the NaN sentinel."""

    def __init__(self, guard: int = GUARD):
        self.guard = guard
        self.buffers: List[tuple] = []  # (flat, view)
        self.unwritten_ok: set = set()  # data_ptr of buffers no one writes

    def alloc(self, shape, dtype: torch.dtype, device) -> torch.Tensor:
        n = math.prod(shape)
        flat = torch.full((n + 2 * self.guard,), float("nan"), dtype=dtype, device=device)
        view = flat[self.guard:self.guard + n].view(tuple(shape))
        self.buffers.append((flat, view))
        return view


def _unfed_landing(run) -> set:
    """The fused state's landing buffers no neighbour pushes into (a
    Dirichlet x domain face reads bc): their cells stay at the sentinel,
    their guard bands are still checked."""
    state = run.state
    if state is None or not state.glo:
        return set()
    out = set()
    for s in run.mesh.local_shards:
        for side, bufs in ((-1, state.glo), (+1, state.ghi)):
            if run.mesh.neighbor(s, 0, side, run.case.periodic) is None:
                out.add(bufs[s.rank].data_ptr())
    return out


def inspect(g: Guarded) -> List[str]:
    """What is wrong with ``g``'s buffers after a launch: cells left at the
    sentinel (but in a buffer no one writes), guard cells written."""
    problems = []
    for i, (flat, view) in enumerate(g.buffers):
        unwritten = torch.isnan(view)
        if view.data_ptr() not in g.unwritten_ok and bool(unwritten.any()):
            first = tuple(int(x) for x in unwritten.nonzero()[0])
            problems.append(("ANL1021", f"buffer {i} {tuple(view.shape)}: "
                             f"{int(unwritten.sum())} cell(s) never written (first at "
                             f"{first})"))
        guards = torch.cat([flat[:g.guard], flat[-g.guard:]])
        touched = ~torch.isnan(guards)
        if bool(touched.any()):
            problems.append(("ANL1022", f"buffer {i} {tuple(view.shape)}: "
                             f"{int(touched.sum())} guard-band cell(s) written past the "
                             "buffer"))
    return problems


def check(cases: Sequence, device, report: Dict) -> List[Finding]:
    from heat3d_tpu_torch.analysis.kernel.cases import Run

    findings: List[Finding] = []
    verdicts = report.setdefault("verdicts", {}).setdefault(CHECKER, {})
    for case in cases:
        try:
            run = Run(case, device)
            g = Guarded()
            if case.family == "dma":
                run.launch(alloc=g.alloc)
            else:
                outs = [g.alloc(s, run.dtype, run.device) for s in run.out_shapes()]
                run.launch(outs, alloc=g.alloc if case.family == "fused" else None)
            if run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
            g.unwritten_ok = _unfed_landing(run)
            problems = inspect(g)
        except Exception as e:  # noqa: BLE001 - a case that cannot run is a finding
            problems = [("ANL1023", f"the case did not run: {type(e).__name__}: "
                         f"{' '.join(str(e).split())[:200]}")]
        verdicts[case.key] = "error" if problems else "clean"
        for code, message in problems:
            findings.append(Finding(
                checker=CHECKER, severity=ERROR, path=_PATH, line=0, code=code,
                symbol=f"{case.key}|{code}",
                message=f"{case.key} (row {case.row}, {case.wrapper}) on {device}: {message}",
            ))
    return findings
