"""``python -m heat3d_tpu_torch.obs ...`` — the obs CLI (same surface as
``heat3d obs ...``)."""

import sys

from heat3d_tpu_torch.obs.cli import main

sys.exit(main())
