"""The communication observatory.

- :mod:`~heat3d_tpu_torch.obs.comm.probe` — the opt-in
  ``HEAT3D_COMM_PROBE`` per-link probe: each (axis, direction, sub-block)
  link of an exchange timed alone as a loop of the transport's own move,
  emitted as ``comm_probe`` ledger events carrying the schedule's predicted
  bytes, so every link reports predicted-vs-achieved GB/s. Imports torch —
  kept out of this package's import path.
- :mod:`~heat3d_tpu_torch.obs.comm.report` — pure aggregation of
  ``comm_probe`` events into the per-link table ``obs summary`` renders.
- :mod:`~heat3d_tpu_torch.obs.comm.adjudicate` — ``obs adjudicate``: from
  bench rows and ledgers to the A/B stage verdicts (halo_plan, halo_order,
  slab width, fused_rdma) through ``tune/decide.py``'s pairing; rc 1 only
  on a ``fail`` verdict.

Ports of the JAX package's modules. Importing this package stays cheap and
torch-free (the obs CLI dispatches through it on machines with no
accelerator stack warm).
"""
