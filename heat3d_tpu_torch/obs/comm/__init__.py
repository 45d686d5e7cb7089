"""The communication observatory's pure part: :mod:`~heat3d_tpu_torch.obs.
comm.report` aggregates ``comm_probe`` events into the per-link table
``obs summary`` renders (a copy of the JAX package's). The probe that
emits those events (``obs/comm/probe.py``: one timed program per link) and
the A/B adjudication (``obs/comm/adjudicate.py``) are not ported yet.

Importing this package stays cheap and torch-free (the obs CLI dispatches
through it on machines with no accelerator stack warm).
"""
