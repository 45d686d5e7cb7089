"""``python -m heat3d_tpu_torch ...`` — the solver command line."""

import sys

from heat3d_tpu_torch.cli import run

sys.exit(run())
