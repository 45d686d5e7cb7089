"""The benchmark of heat3d_tpu_torch, the PyTorch and CUDA package.

One run is one process: ``python3 -m portbench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout. It
builds the cell's solver, makes the initial field from the seed, warms up,
drives the solver's public entry for ``--seconds``, checks what the timed
path produced against the plain reference (``portbench.reference``), and
prints one JSON line.

Everything is found by name from ``BENCHMARK.json``: a cell's
configuration in ``configs/<config>.json`` and the system module it names
in ``systems/<system>.py`` (the solver, the control, the reference), its
traffic mix in ``mixes/<traffic>.json`` (data) and the entry module it
names in ``entries/<entry>.py`` (how one chunk drives the solver), the
limits of its comparison in ``limits/<cell>.json``, and each metric's
reader in ``metrics/<metric>.py``. A new cell, configuration, mix or metric
is new files and entries. Nothing here imports JAX or the JAX package.
"""
