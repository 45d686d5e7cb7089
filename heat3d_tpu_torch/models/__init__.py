"""Solver models: the user-facing facade."""

from heat3d_tpu_torch.models.heat3d import HeatSolver3D  # noqa: F401
