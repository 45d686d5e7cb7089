"""Whether what the timed path produced is correct: the comparison with
the plain reference.

Two answers of the run are checked, each against the reference run over
the same input for the same updates:

- the start: the first call, in set-up, from the seed's field (the
  reference makes that field again from the seed);
- a sample of the window: the call of the chunk drawn from the seed, from
  the program's own state before it (the benchmark's copy) to the field it
  handed on (the other copy); where the mix's entry reads a residual back,
  also the residual that call read.

Numbers: ``field_gap``, the largest gap over the whole field relative to
the reference's largest value; ``face_gap``, the same over the six faces
next to the Dirichlet ghosts; ``residual_gap``, the gap between the
residual read back and the reference's, relative to the reference's
residual. Each has its limit in ``limits/<cell>.json``; a number that is
not a number fails, and so does a residual that never came.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import cells, data
from portbench.reference.heat import face_gap, max_gap

REFERENCE_RESIDUAL = torch.float64


def _rel(gap: float, scale: float) -> float:
    return gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf"))


def _numbers(got: torch.Tensor, want: torch.Tensor, got_r, want_r) -> Dict[str, float]:
    out = {"field_gap": _rel(*max_gap(got, want)), "face_gap": _rel(*face_gap(got, want))}
    if want_r is not None:
        out["residual_gap"] = (float("nan") if got_r is None
                               else _rel(abs(got_r - want_r), want_r))
    return out


def compare(config: dict, mix: dict, seed: int, run, device: str,
            grid=None) -> List[Tuple[str, Dict[str, float]]]:
    """``[(answer, {number: value})]`` for the start and the sample."""
    shape = tuple(grid or config["grid"])
    ref = cells.system(config).reference(config, device, shape)
    residual = REFERENCE_RESIDUAL if cells.entry(mix).RESIDUAL else None
    u0 = data.initial_field(seed, shape, device, getattr(torch, config["storage"]))
    want, want_r = ref.run(u0, int(mix["start_updates"]), residual)
    del u0
    answers = [("start", _numbers(run.start, want, run.start_residual, want_r))]
    want, want_r = ref.run(run.sample_in, int(mix["chunk_updates"]), residual)
    answers.append((f"chunk{run.sample_chunk}",
                    _numbers(run.sample_out, want, run.sample_residual, want_r)))
    return answers


def judge(answers, limits: Dict[str, float]):
    """(correct, failed answers, {number: (largest value, limit)})."""
    failed = 0
    worst: Dict[str, Tuple[float, float]] = {}
    for _, numbers in answers:
        bad = False
        for name, value in numbers.items():
            limit = limits[name]
            bad |= not value <= limit  # NaN fails
            prev = worst.get(name, (None, limit))[0]
            if prev is None or not value <= prev:
                worst[name] = (value, limit)
        failed += bad
    return failed == 0, failed, worst
