"""Legacy-VTK output for visualization tools (ParaView/VisIt).

A copy of ``heat3d_tpu.utils.vtkio`` (pure NumPy): ``--dump-vtk`` writes
the same bytes in both packages.

Reference parity (SURVEY.md §5 "Checkpoint / resume": the reference class's
richest output is "a final-state binary/VTK dump for visualization";
SURVEY.md §4: correctness by "visual/numeric inspection of dumped slices").
This module writes the classic ``STRUCTURED_POINTS`` legacy format — the
one every VTK reader ingests without XML machinery — so a reference user's
ParaView workflow carries over unchanged.

Scalars are written BINARY big-endian float32 (the legacy-format
requirement) with x varying fastest (the VTK point-ordering convention);
our fields are indexed ``u[i, j, k]`` = (x, y, z), so the transpose is
taken internally.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def write_structured_points(
    path: str,
    field: np.ndarray,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    name: str = "u",
    title: str = "heat3d-tpu field",
) -> None:
    """Write a 3D (or single-plane 2D) scalar field as legacy binary VTK.

    ``field`` is indexed (x, y, z); a 2D array (a dumped slice) is written
    as a one-cell-thick volume so the same viewers open it."""
    u = np.asarray(field)
    if u.ndim == 2:
        u = u[:, :, None]
    if u.ndim != 3:
        raise ValueError(f"field must be 2D or 3D, got shape {u.shape}")
    nx, ny, nz = u.shape
    # VTK points run x fastest, z slowest: C-ravel of the (z, y, x) view.
    data = np.ascontiguousarray(u.T.astype(">f4"))
    header = (
        "# vtk DataFile Version 3.0\n"
        f"{title}\n"
        "BINARY\n"
        "DATASET STRUCTURED_POINTS\n"
        f"DIMENSIONS {nx} {ny} {nz}\n"
        f"ORIGIN {origin[0]:g} {origin[1]:g} {origin[2]:g}\n"
        f"SPACING {spacing[0]:g} {spacing[1]:g} {spacing[2]:g}\n"
        f"POINT_DATA {nx * ny * nz}\n"
        f"SCALARS {name} float 1\n"
        "LOOKUP_TABLE default\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())
        f.write(b"\n")


def read_structured_points(path: str) -> Tuple[np.ndarray, dict]:
    """Read back a file written by :func:`write_structured_points` —
    the test oracle (and a convenience for quick numpy-side inspection;
    not a general VTK parser)."""
    with open(path, "rb") as f:
        raw = f.read()
    head, _, rest = raw.partition(b"LOOKUP_TABLE default\n")
    meta = {}
    for line in head.decode("ascii", errors="replace").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] in ("DIMENSIONS", "ORIGIN", "SPACING"):
            meta[parts[0].lower()] = tuple(
                (int if parts[0] == "DIMENSIONS" else float)(v)
                for v in parts[1:4]
            )
        elif parts[0] == "SCALARS":
            meta["name"] = parts[1]
    nx, ny, nz = meta["dimensions"]
    data = np.frombuffer(rest, dtype=">f4", count=nx * ny * nz)
    # undo the x-fastest ordering back to (x, y, z) indexing
    field = data.reshape((nz, ny, nx)).T
    return np.ascontiguousarray(field.astype(np.float32)), meta
