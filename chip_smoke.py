#!/usr/bin/env python3
"""On-card smoke test of heat3d_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py
    python3 chip_smoke.py --only dma_times,fused_times   # a short check

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and exits
non-zero without one. Phases, each printing its own lines:

1. identify the card (nvidia-smi name and power limit, torch and CUDA);
2. build the CUDA kernels from ``heat3d_tpu_torch/csrc`` (one nvcc per
   source, all started together) and print each source's build seconds,
   the compiler's resource report, and each stream instance's (k = 1..4 x
   the 7pt, 27pt and generic instances x fp32/bf16 storage), direct
   instance's (halo 1 and 2 x the same instances and the Mehrstellen
   q-ring instance) and fused instance's (the one- and two-update
   kernels' 7pt, 27pt and generic instances) shared memory, registers,
   spills and resident blocks per SM, each compile-time instance and the
   generic sweeps (``direct_generic<T,H,M>``, ``stream_generic<T,K,M>``)
   in fp32 and in bf16 compute (the ``Bf16Math`` policy; keys end
   ``_bf16c``); the stream generic sweep must hold two fp32 blocks an SM
   at every k and spill nothing;
3. hold each kernel against its plain PyTorch version on the card, bitwise,
   for 7pt/27pt x Dirichlet (bc 0 and 0.3)/periodic x fp32/bf16 storage at
   ragged shapes, 128^3 (the golden phase's grid) and 256^3: the direct
   kernels (tb 1 and 2), the stream kernel and streamk at k = 2, 3, 4 over
   the halo exchange; the direct kernels also at shapes with nx below 2H+1,
   odd nz, y and z no multiple of their tiles, nx = 1024 cut into x-chunks
   and a forced 3-plane x-chunk; every stencil kernel's generic instance at
   128^3 under the factoring knobs (``HEAT3D_FACTOR_7PT=1``,
   ``HEAT3D_FACTOR_Y=0``, both; the fused kernels too, over (4,1,1)),
   each launch on the instance ``stream_instance`` names; the stream
   kernels' generic instance forced at k = 1..4 on the advection-diffusion
   vx=2, zero-centre, asymmetric 27pt and random 27-term programs at ragged
   interiors and on the special-value field, three x-chunks, both storages
   and compute policies, three boundary settings and three domain-edge
   masks (``_compare_stream_generic``); also
   the streamk plain version against k
   direct kernel launches, and the exchange-path solve of k steps against
   the direct-path solve, both bitwise;
   ``compare_mehrstellen``: under ``HEAT3D_MEHRSTELLEN=1`` both
   Mehrstellen instances bitwise against their plain versions at the
   direct kernels' ragged shapes, a forced 3-plane x-chunk, 128^3 and
   1024^3 (fp32/bf16 x three boundary settings), the (2,2,2) faces-direct
   solve against the (1,1,1) solve at 128^3 (tb 1 and 2), and the 27pt
   tb=4 and ``fused-dma2`` solves, which keep the tap chain, equal to
   their knob-off solves;
   ``compare_bf16``: every bf16-compute instance (``compute_dtype=
   torch.bfloat16``) bitwise against its plain version in bf16 compute,
   each launch counted as one: the direct kernels at their ragged shapes
   and a forced 3-plane x-chunk, every stencil kernel at (33,17,129) and
   128^3, the Mehrstellen instances, the generic instances forced (the
   fused ones over (4,1,1)), the fused kernels over (8,1,1), the RDMA ones
   over (4,1,1) (floor 0 and the default) and over a ragged (2,1,1);
   7pt/27pt x fp32/bf16 storage x the boundary settings;
4. the sharded solve, every shard on ``cuda:0`` on a stream of its own,
   bitwise: the DMA halo kernels against their plain version (meshes
   (2,1,1) .. (2,2,2), widths 1-4, three boundary settings, fp32/bf16, at
   (66,34,258) and 128^3, and 50 exchanges in a row per mesh), the streamk
   kernel's domain-edge mask on the interior and edge shards of a (3,3,3)
   mesh, and the sharded solve on (2,2,2) against the (1,1,1) solve at
   128^3 for every route;
5. the main path against the fp64 golden oracle: the solver command line
   at 128^3, 20 steps, 7pt and 27pt, ``--golden-check``, at tb 1, 2, 3 and
   4, with ``HEAT3D_NO_DIRECT=1`` (the exchange path) at tb 1 and 2, and on
   a (2,2,2) mesh on ``cuda:0`` (``--halo ppermute`` tb 1/2/4, ``--halo
   dma`` tb 1/4; and an uneven 129^3 grid); under ``HEAT3D_MEHRSTELLEN=1``
   27pt tb 1 and 2 in fp32 and bf16 storage on the Mehrstellen instance;
   with ``--compute-dtype bf16`` (10 steps): 7pt tb 1, 2 and 4 in fp32
   and bf16 storage, the exchange path, the Mehrstellen instances and the
   four fused kernels, each launching its bf16-compute instance; and the
   7pt bf16-compute drift at 10 and 20 steps (``_bf16_drift``: printed
   beside the gate, the solve held bitwise to the plain per-op update);
6. the main path at full width: ``bench_throughput`` at 1024^3 (fp32 7pt
   tb=2, the headline config; fp32 7pt tb=1; fp32 27pt tb=2; bf16 7pt
   tb=2; then the exchange path: fp32 7pt tb=4, tb=3 and tb=1 under
   ``HEAT3D_NO_DIRECT``, fp32 27pt tb=4, bf16 7pt tb=4; then sharded on a
   (2,2,2) mesh on one card: ``halo='dma'`` tb 1 and 4, ``ppermute`` tb 1
   and 2) with Gcell-updates/s, ms per superstep, the exchange's ms, the
   redundant-flops fraction and the end-to-end bound, and periodic 1024^3
   runs (tb=2 and tb=4, and ``halo='dma'`` tb=4 on (2,2,2); 11 steps) held
   to conservation of sum(u); under ``HEAT3D_MEHRSTELLEN=1`` (27pt) direct
   tb=2, tb=1, bf16 tb=2, (2,2,2) faces-direct tb 1 and 2 (Mehrstellen
   instance) and tb=4 and (8,1,1) ``fused-dma2`` (the chain), each row's
   route provenance checked, and the (2,2,2) faces-direct solve at 1024^3
   held bitwise to the (1,1,1) solve (tb 1 and 2); and BASELINE config
   5's precision (bf16 stencil, fp32 residual) cut to one card
   (``_FULL_WIDTH_BF16``: fp32 storage 7pt tb 2 and 4, bf16 storage tb=2,
   27pt Mehrstellen tb=2, (8,1,1) ``fused-dma2``, (4,1,1) ``fused-rdma``
   tb=1), each launching bf16-compute instances;
7. kernel and plain-version times at 256^3 and 1024^3 fp32 7pt, each
   kernel held bitwise to its plain version there (also with bc 0.3,
   periodic, 27pt and bf16 storage: the full-width phase's settings), the
   halo exchange's time at each width, and the library call's time
   (F.conv3d, no TF32) over the same input as the tb=1 and the stream
   kernel, held to them within a stated rounding bound; the direct and
   stream kernels' generic instances forced on the 7pt chain and on the
   advection-diffusion vx=2 program beside them (each launch bitwise, with
   its bound; ``stream_times`` prints the stream ones at k = 1..4 with
   their resources and ``generic_over_compiled``), and
   direct1/direct2 in their 27pt fp32 and 7pt bf16 instances
   at 1024^3 with registers, spills and blocks per SM; the stream kernel
   and streamk K=4 in their 27pt fp32 and 7pt bf16 instances at 1024^3
   (bitwise, timed beside their bounds), and the ratios stream1 / direct1,
   streamk K=2 / direct2 and K=4 / direct2 of the same call; the DMA
   exchange per axis on 512^3 shards of a (2,2,2) mesh at widths 1 and 4
   (ms of a single call and of 20 calls in a row, beside the plain slab
   copies timed both ways, the byte bound, the sector floor and the
   launches a call makes);
   and each stencil kernel the (2,2,2) rows launch, on those 512^3 shards
   (streamk K=4 under corner shards' domain-edge masks), held bitwise to
   its plain version and timed beside its 512^3 bound;
   ``mehrstellen_times``: the Mehrstellen instances at 1024^3 (fp32, bf16)
   beside the 27pt chain instances of the same call and their bounds, with
   registers, spills and blocks per SM, and at tb=1 the library call (a
   27pt ``F.conv3d``, TF32 off);
   ``compute_bf16_times``: each bf16-compute instance at 1024^3 beside
   the fp32-compute instance of the same chain in the same call (timed
   fp32, bf16, bf16, fp32), with the bound (the storage dtype's bytes),
   registers, spills and blocks per SM, each bf16 launch held bitwise;
8. across GPUs: the (2,1,1) DMA check with the shards on ``cuda:0`` and
   ``cuda:1``, and the four fused kernels on that mesh, when two GPUs are
   visible (else one line says it did not run, and why);
9. the fused exchange-and-sweep kernels (``csrc/stencil_fused.cu``: fused
   DMA tb 1/2, fused RDMA tb 1/2), every shard on ``cuda:0`` in one launch:
   phase 4 holds them bitwise to their plain versions on (4,1,1), (8,1,1)
   and (2,2,2) at 128^3 (with the landed ghosts), 7pt/27pt x Dirichlet
   0.3/periodic x fp32/bf16, the RDMA ones with the plan's sub-blocks at
   the default floor and at floor 0, at the full-width shard shapes of
   1024^3 over (8,1,1) and (4,1,1), and on a ragged, odd ny*nz (2,1,1)
   mesh (sends whole, in two and in three ranges); 50 launches in a row
   without a host
   sync; a state built mid-run on busy streams (1024^3 on (8,1,1), tb=2, 11
   steps, equal to the (1,1,1) solve); and every overlap route's 128^3
   solve against the (1,1,1) solve. Phases 5 and 6 run the overlap routes
   through the command line (golden) and ``bench_throughput`` (1024^3);
   phase 7 times each fused kernel at 1024^3 over all shards of the card
   (on its compile-time instance and on the generic instance forced, in
   the same call);
10. ``halo_bench``, the judged halo-exchange p50 (``bench_halo``), after
   the main path (its launches are not in the ``main_path`` counts): the
   card's name and power limit on its first line; held bitwise first: the
   benchmark's loop on the DMA kernels against the same loop on their plain
   version at k = 7 and 4096 exchanges without a host sync ((2,2,2) at
   128^3, fp32 and bf16), the pairwise exchange against the axis-ordered
   one on every face-ghost cell with its edge zones at bc, and a pairwise
   ``--golden-check`` run (128^3, (2,2,2) on cuda:0, 20 steps, launching
   the stream kernel); then one line per row of ``_HALO_ROWS`` at 1024^3
   (every shard on cuda:0): p50, p95 of program means, exchanges per
   program and plan messages, beside the same exchange timed alone (on a
   sharded mesh also its interior copy and its pushes alone) and
   ``bound_us``, its bytes at the card's memory rate.

11. ``families``, after the main path, the explicit equation families at
   1024^3 fp32 (``_FAMILY_ROWS``: ``aniso-diffusion`` tb 2 and 1,
   ``advection-diffusion`` vx=2 tb 1 on (1,1,1) and faces-direct on (2,2,2),
   tb 2 and 4 on (1,1,1) and tb 2 on (8,1,1) ``--halo dma --overlap``
   (``fused-dma2``: the fused generic instance), ``reaction-diffusion``
   rate 0.5 27pt tb 2 and 7pt tb 4): each row's kernel on a random field
   (the sharded rows: on each shard; the fused row: one launch over the
   shards, Dirichlet 0.3 and periodic) held bitwise to its plain version
   for the three boundary settings, the (2,2,2) advection step (kernel and the shells at
   asymmetric taps) held bitwise to the (1,1,1) step; then, with the launch
   counts zeroed, each row through ``bench_throughput`` (Gcell/s, ms per
   superstep beside its bound, the instance its launches took: a family
   whose emission program is no ``CHAINS`` entry, as advection's unfactored
   x pair, takes the generic instance) and each family's 128^3
   ``--golden-check`` through the command line (gate 1e-5); the counts read
   after must show the direct, direct2 and streamk kernels;
12. ``integrators``, with the launch counts zeroed before and read after
   (the integrators run the plain chain over the ppermute exchange, as the
   JAX package pins them, so no kernel may launch): ``wave`` + leapfrog
   at 128^3 (7pt and 27pt at tb 1, 7pt at tb 2; 10 steps from random
   levels) over (2,2,2) bitwise equal to (1,1,1) and within 1e-5 (relative)
   of ``leapfrog.reference_step`` in fp64; ``heat`` + implicit-CG at 4x the
   explicit dt over (1,1,1) and (2,2,1) (2 steps, ``last_cg_stats``
   printed) within 5e-5 of ``cg.reference_solve`` and the sharded solve
   within 1e-5 of the field's largest value of the (1,1,1) one; then at
   full width leapfrog 7pt tb 1 and 2 at 1024^3 and CG 7pt at the largest
   cube of ``_CG_CUBES`` that fits, each with its ms a step and
   ``torch.cuda.max_memory_allocated()``.
13. ``state``, after ``integrators``, in a temporary directory (fails,
   naming the bytes, without ``_STATE_DISK`` free there; removed at the
   end), every line with the card's name and power limit: a 1024^3 fp32
   7pt tb=2 solve of 20 steps against 10 steps, ``save_checkpoint``, a
   fresh solver's ``load_checkpoint`` and 10 more, bitwise, direct2
   launched, the save's and load's seconds, GB/s and shares (device-to-host
   copy, checksum, file write; file read, checksum, host-to-device copy);
   at 512^3 a (2,2,2) save resumed on (1,1,1), a bf16 round trip and
   leapfrog's two-level carry resumed, each bitwise; supervised 512^3
   (2,2,2) runs on ``cuda:0`` under ``_STATE_FAULTS`` (backend loss healed
   by the real probe child, a hang under a 3 s watchdog, a corrupt
   generation quarantined, a partial device loss re-planned onto (4,1,1)
   under ``heal_mode='elastic'`` over ``halo='dma'``, its stream and DMA
   launches counted), each bitwise equal to a clean supervised run, each
   recovery record printed; the supervised command line at 256^3 killed by
   ``HEAT3D_FAULTS=sigterm:step=4`` (exit 3) and relaunched (exit 0), its
   final generation byte-equal to a clean run's; ``--dump-vtk`` at 128^3
   equal to ``gather``; the probe child's ``"cuda"`` and its seconds.
14. ``obs``, after ``state``, in a temporary directory, every line with the
   card's name and power limit: the command line with ``--ledger`` and
   ``--profile`` at the 1024^3 tb=2 headline (20 steps) and on the
   host-bound (2,2,2) rows, faces-direct tb=1 and ``fused-dma-3d`` at
   1024^3 and 512^3 (10 steps, every shard on cuda:0, ``_OBS_RUNS``): each
   ledger linted clean with the taxonomy on and holding run_start, warmup,
   run_loop, step_cost (platform cuda, the analytic bytes), an engaged
   profile_capture and run_summary; every kernel the run launched on the
   device by name; each run's device ms per phase and superstep, its
   device busy share (the union of device intervals over the shard
   streams, over the timed window) and its five longest idle gaps with the
   host range open in each; the headline at least ``_OBS_PHASE_SHARE`` of
   its device time under a ``heat3d.*`` phase and its stencil phase per
   superstep within ``_OBS_STENCIL_TOL`` of direct2's CUDA-event time. In
   this process: the headline's Gcell/s with a ledger against without
   (within ``_OBS_LEDGER_TOL``), faces-direct tb=1's host and wall time a
   superstep with the phase ranges against without (``_OBS_RANGE_ROUNDS``
   rounds of four runs in turns, the median of the rounds' ratios) and one
   range's host cost; ``obs roofline`` live on the headline (GB/s per
   phase against the card's rate, GFLOP/s against its fp32 rate) and
   ``--calibrate`` (the GFLOP/s the 27pt direct kernel achieves at 512^3,
   stored, never a peak). The bounds of every phase come from
   ``heat3d_tpu_torch/obs/perf/roofline.py``, the package's one cost model.

15. ``tune``, after ``obs``, in a temporary directory (store and ledgers;
   every phase resolves auto knobs against a store of the run's own, never
   the user's), every line with the card's name and power limit: ``tune
   run`` at 1024^3 on one shard over backend pallas/jnp x tb 1-4 (the
   winner pallas tb=2 within 3% of the main path's tb=2 row, ``tune lint``
   and ``obs check`` clean, the default lattice's enumeration time); the
   command line with ``--time-blocking 0`` resolved through that store
   (``tune_cache_hit``, tb 2), under ``HEAT3D_TUNE_DISABLE=1`` and with the
   entry's kernels digest altered (tb 1), each within 3% of its explicit
   twin, and no device memory allocated by ``resolve_config``; ``tune
   run`` on (8,1,1) with every shard on cuda:0 within a budget (its key's
   ``s8`` leg); ``bench_halo`` under ``HEAT3D_COMM_PROBE=1`` on (2,2,2)
   (ppermute monolithic and partitioned, dma): one ``comm_probe`` event
   per link with the schedule's bytes; ``obs adjudicate`` over the rows.

16. ``multiprocess``, last, in a temporary directory, every line with the
   card's name and power limit: the command line as two ranks
   (``--coordinator localhost:PORT --num-processes 2 --process-id p``,
   every shard on ``cuda:0``, output to files, each launch under
   ``_MP_TIMEOUT_S``), ``_MP_BATCH`` pairs at once: the 128^3
   ``--golden-check`` runs on the default wire, which is the peer wire
   (CUDA IPC: the two ranks map each other's blocks and protocol words),
   of ``_MP_GOLDEN`` on (2,2,2) (faces-direct tb 1 and 2,
   ``HEAT3D_NO_DIRECT=1`` tb 1, tb 4) and of ``_MP_PEER``, the routes
   that store into peer memory (``--halo dma`` tb 1 and 4 and ``--halo
   dma --overlap`` on (2,2,2), ``--halo dma --overlap`` tb 1 and 2 on
   (8,1,1), ``--fused-rdma on --halo-plan partitioned`` tb 1 and 2 on
   (4,1,1)), and faces-direct tb 1 on ``HEAT3D_WIRE=host``; each passing
   the golden check, its residual and routes equal to the one-process run
   of the same command (in this process), its summary on rank 0 alone,
   each rank on the wire asked for (``process_wire`` ``transport``; the
   peer signal and wait launched on the peer wire only) and launching its
   row's kernels; a checkpoint at step 5 by two ranks resumed by two ranks
   to step 10, every shard file byte-equal to one process's uninterrupted
   save and the manifest listing 8 shards; 1024^3 fp32 7pt, 10 steps, the
   runs of ``_MP_FULL_RUNS`` (faces-direct tb=2 on (2,2,2) on the peer and
   the host wire, ``fused-dma2`` on (8,1,1) on the peer wire), each
   residual bitwise equal to one process's, with both Gcell/s and each
   rank's wire host milliseconds per round that carried faces
   (``parallel.wire.totals``); one rank per GPU when two are visible (else
   a line says why not).

17. ``serve``, after ``multiprocess``, in a temporary directory, every
   line with the card's name and power limit (``phase_serve``): the
   ``serve --requests`` command over 168 seeded records in five buckets
   (``_serve_records``: 128 x 128^3 7pt fp32, two batches of 64; 16 x
   256^3 27pt tb=2; 8 coefficient-field, 8 advection-diffusion and 8 bf16
   members at 128^3) at ``HEAT3D_SERVE_MAX_BATCH``'s default of 64: per
   bucket members, padded size, seconds, Gcell/s, request latency
   p50/p95/max and peak device memory; each bucket's first batch rebuilt
   as the queue builds it, two of its members alone (B=1) bitwise to it,
   the same two through ``bind='baked'`` and solo ``HeatSolver3D``
   (backend jnp) with their ``max_abs_err`` (0.0 expected); every heat
   member of A and E and the two checked members of B against the fp64
   golden computed on the card (held to ``core.golden.step`` first), the
   coefficient-field members against
   ``reference_varcoef_step``; bucket A's first batch on (2,2,2) and at
   ``batch_mesh=2`` bitwise to (1,1,1); no hand-written kernel launched
   while serving; ``serve --bench`` (64 members, 128^3) beside the solo
   jnp and direct-kernel rows; ``tune run --batch-members 16`` (a jnp
   winner under ``b2^4``, resolved by an ``EnsembleSolver``). It adds no
   kernel: the kernels line is as before.

18. ``serve_async``, after ``serve``, in a temporary directory, every line
   with the card's name and power limit (``phase_serve_async``): ``serve
   --requests --async --residuals --workers 2`` over the C, D and E
   records of ``_serve_records`` and 32 of A's, every result line equal to
   the synchronous command's over the same records (queue latency aside),
   with seconds per bucket async against sync, each bucket's warm-up stall,
   the workers' overlap and peak device memory; a 30 s seeded soak
   (``serve --loadgen --monitor``: ``tenant-a`` 128^3 7pt fp32, 100 steps,
   weight 3; ``flood`` 64^3 27pt tb=2, 50 steps, a burst x8 for 2 s every
   10 s; 6 Hz; max batch 8, 16 open a stream, 2 workers) with a partial
   device loss injected at batch 3 through ``HEAT3D_FAULTS``: verdict
   ``ok``, no stall after warmup, a requeue, degraded seconds, shed
   counted, order kept, the sustained member Gcell/s and per-bucket
   p50/p95/p99; the same mix under an impossible SLO with
   ``--abort-on-burn`` ending early with rc 1; ``obs slo`` and ``obs watch
   --once`` over the soak's ledger; no hand-written kernel launched.

19. ``lint``, last, every line with the card's name and power limit
   (``phase_lint``): ``python -m heat3d_tpu_torch lint --all --json`` as a
   child on ``cuda:0`` (the five source checkers and the kernel tier's
   seven families over the judged matrix of ``analysis/kernel/cases.py``,
   68 cases of rows 1–12 at 37x41x43 a shard): rc 0, no error, every
   case with each family's verdict, the seeded racy kernel flagged by
   racecheck (or, where ``compute-sanitizer`` refuses the card, every
   sanitizer verdict "not certified" and a ``lint_refused`` line with the
   tool's words); one ``lint_resources`` line per kernel instance (shared
   memory, registers, blocks per SM, spills); then the coverage (NaN
   sentinels, guard bands) and remote (rank stamps) families at the main
   path's full width in this process (1024^3 on one shard, (2,2,2) of
   512^3, (8,1,1) of 128x1024^2), clean; then the provenance lint and
   ``bench.report`` over every row this run's bench calls wrote
   (``_BENCH_ROWS``): no defect, every row in the printed tables.

The golden checks of phase 5 run the fp64 oracle through ``impl='auto'``,
the OpenMP stepper (``native/``, asserted built); ``golden_native`` times
it beside NumPy at 128^3 (7pt and 27pt, 20 steps, within 1e-13).

``--only`` runs phases 1 and 2 and the named ones of ``PHASES`` (the
check after a kernel change, before the whole run) and prints no kernels
line. The kernel launch counts are zeroed just before phase 5 and read just after
phase 6; the script fails if any kernel was not launched there, if a
direct, stream or fused kernel launch there took the generic instance, or
if a computing wrapper (all but the DMA pair; the Mehrstellen instances
too) launched no bf16-compute instance there
(``compute_bf16_instance_launches``).
The ``main_path``
line also gives each wrapper's output cells as launches of the size the
kernels line times (1024^3-equivalent launches) and the Mehrstellen
instances' launches; the script fails if the knob's rows launched none.
The last
three lines are the kernels' JSON object (``{"kernels": [...]}``: the
nine wrappers and the two Mehrstellen instances; each computing entry
with ``compute_bf16_ms``, its ``max_abs_err`` the worst over both compute
dtypes), the
nvidia-smi line, and the status object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

# The card's peak rates and every bound of this script (bytes each input
# read once and each output written once, at the card's memory rate; the
# operations at its fp32 rate) come from the package's one cost model, so
# PERF.md's bound column, the ledger's step_cost and the bench rows' cost
# fields read one yardstick.
from heat3d_tpu_torch.obs.perf.roofline import (  # noqa: E402
    BOUND_PASSES as _BOUND_PASSES,
    bandwidth,
    bound_ms,
    flops_per_update,
    fused_bound,
    halo_exchange_bytes,
    kernel_bound,
    sharded_superstep_bound,
    superstep_bound,
)

_SOURCES = {
    "apply_taps_direct": "heat3d_tpu_torch/csrc/stencil_direct.cu",
    "apply_taps_direct2": "heat3d_tpu_torch/csrc/stencil_direct.cu",
    "apply_taps_stream": "heat3d_tpu_torch/csrc/stencil_stream.cu",
    "apply_taps_streamk": "heat3d_tpu_torch/csrc/stencil_stream.cu",
    "halo_dma": "heat3d_tpu_torch/csrc/halo_dma.cu",
    "apply_step_fused_dma": "heat3d_tpu_torch/csrc/stencil_fused.cu",
    "apply_superstep_fused_dma": "heat3d_tpu_torch/csrc/stencil_fused.cu",
    "apply_step_fused_rdma": "heat3d_tpu_torch/csrc/stencil_fused.cu",
    "apply_superstep_fused_rdma": "heat3d_tpu_torch/csrc/stencil_fused.cu",
}
_REPLACES = {
    "apply_taps_direct": "heat3d_tpu/ops/stencil_pallas_direct.py:422",
    "apply_taps_direct2": "heat3d_tpu/ops/stencil_pallas_direct.py:656",
    "apply_taps_stream": "heat3d_tpu/ops/stencil_pallas.py:257, "
                         "heat3d_tpu/ops/stencil_pallas.py:797",
    "apply_taps_streamk": "heat3d_tpu/ops/stencil_pallas.py:694, "
                          "heat3d_tpu/ops/stencil_pallas.py:451",
    "halo_dma": "heat3d_tpu/ops/halo_pallas.py:153, "
                "heat3d_tpu/ops/halo_pallas.py:274",
    "apply_step_fused_dma": "heat3d_tpu/ops/stencil_dma_fused.py:515",
    "apply_superstep_fused_dma": "heat3d_tpu/ops/stencil_dma_fused.py:894",
    "apply_step_fused_rdma": "heat3d_tpu/ops/stencil_fused_rdma.py:193",
    "apply_superstep_fused_rdma": "heat3d_tpu/ops/stencil_fused_rdma.py:299",
}
# the fused kernels: (updates, plain version's name in ops.stencil_dma_fused)
_FUSED = {
    "apply_step_fused_dma": (1, "reference_fused_step"),
    "apply_superstep_fused_dma": (2, "reference_fused_superstep"),
    "apply_step_fused_rdma": (1, "reference_fused_step"),
    "apply_superstep_fused_rdma": (2, "reference_fused_superstep"),
}
KERNELS = tuple(_SOURCES)
# the Mehrstellen q-ring instances of the direct kernels (HEAT3D_MEHRSTELLEN,
# 27pt): a line each in the kernels' JSON beside their wrapper's, as
# (wrapper, halo)
_MEHR = {"apply_taps_direct:mehrstellen": ("apply_taps_direct", 1),
         "apply_taps_direct2:mehrstellen": ("apply_taps_direct2", 2)}
# the kernels that compute (all but the DMA pair, which moves bytes), with a
# bf16-compute instance each
COMPUTE_KERNELS = tuple(n for n in KERNELS if n != "halo_dma") + tuple(_MEHR)
# the depth whose time stands in the kernels' line for streamk: the
# full-width phase's headline exchange-path config (tb=4)
_STREAMK_HEADLINE = 4
_BCS = ((False, 0.0), (False, 0.3), (True, 0.0))
# the sharded phases' mesh, every shard on cuda:0
_MESH = (2, 2, 2)
_DMA_MESHES = ((2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2))


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def _say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


@contextlib.contextmanager
def _no_direct(on: bool):
    """``HEAT3D_NO_DIRECT=1`` (the exchange path) for the block when ``on``."""
    if not on:
        yield
        return
    os.environ["HEAT3D_NO_DIRECT"] = "1"
    try:
        yield
    finally:
        del os.environ["HEAT3D_NO_DIRECT"]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _taps(kind: str, n: int = 8):
    """The solver's taps for stencil ``kind`` on an n^3 grid."""
    from heat3d_tpu_torch.core.config import GridConfig
    from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps

    g = GridConfig.cube(n)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


def _bc(periodic: bool):
    from heat3d_tpu_torch.core.config import BoundaryCondition

    return BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET


def phase_identify() -> str:
    import torch

    smi = nvidia_smi()
    _say("identify", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def _instance_name(code: int) -> str:
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    if code == sd.MEHRSTELLEN:
        return "mehrstellen"
    return ss.CHAINS[code][0] if code in ss.CHAINS else "generic"


# the key suffix of a bf16-compute instance (the arithmetic policy
# Bf16Math of csrc/stencil_common.cuh); fp32-compute keys have none
BF16C = "_bf16c"
_DTYPE_NAMES = {"f": "float32", "13__nv_bfloat16": "bfloat16"}


def _compute_tag(entry: str) -> str:
    """``BF16C`` for a kernel of the bf16 policy, by its mangled name."""
    return BF16C if "Bf16Math" in entry else ""


def _ptxas(source: str, kernel: str, prefix: str) -> dict:
    """Registers and spills (bytes) of each compile-time instance of
    ``kernel`` in ``source``, from the compiler's report, keyed
    ``<prefix><n>_<chain>_<dtype>`` (+ ``BF16C`` in bf16 compute)."""
    import re

    from heat3d_tpu_torch.ops import _build

    out = {}
    for entry, r in _build.ptxas_report(source).items():
        m = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d)ELi(\d)E", entry)
        if m:
            out[f"{prefix}{m.group(2)}_{_instance_name(int(m.group(3)))}_"
                f"{_DTYPE_NAMES[m.group(1)]}{_compute_tag(entry)}"] = r
    return out


def _direct_ptxas() -> dict:
    """Registers and spills (bytes) of each direct instance, keyed
    ``h<halo>_<instance>_<dtype>`` (+ ``BF16C``): the compile-time ones by
    chain, the generic sweep ``direct_generic<T,H,M>`` as ``generic``."""
    import re

    from heat3d_tpu_torch.ops import _build

    out = _ptxas("stencil_direct", "direct_kernel", "h")
    for entry, r in _build.ptxas_report("stencil_direct").items():
        m = re.search(r"direct_genericI(f|13__nv_bfloat16)Li(\d)E", entry)
        if m:
            out[f"h{m.group(2)}_generic_{_DTYPE_NAMES[m.group(1)]}{_compute_tag(entry)}"] = r
    return out


def _stream_ptxas() -> dict:
    """Registers and spills (bytes) of each stream instance, keyed
    ``k<k>_<instance>_<dtype>`` (+ ``BF16C``): the compile-time ones by
    chain, the generic sweep ``stream_generic<T,K,M>`` as ``generic``."""
    import re

    from heat3d_tpu_torch.ops import _build

    out = _ptxas("stencil_stream", "stream_kernel", "k")
    for entry, r in _build.ptxas_report("stencil_stream").items():
        m = re.search(r"stream_genericI(f|13__nv_bfloat16)Li(\d)E", entry)
        if m:
            out[f"k{m.group(2)}_generic_{_DTYPE_NAMES[m.group(1)]}{_compute_tag(entry)}"] = r
    return out


def _fused_ptxas() -> dict:
    """Registers and spills (bytes) of each fused instance, keyed
    ``h<halo>_<instance>_<dtype>`` (+ ``BF16C``): the compile-time ones by
    chain, the generic sweep ``fused_generic<T,H,M>`` as ``generic``."""
    import re

    from heat3d_tpu_torch.ops import _build

    out = _ptxas("stencil_fused", "fused_chain_kernel", "h")
    for entry, r in _build.ptxas_report("stencil_fused").items():
        m = re.search(r"fused_genericI(f|13__nv_bfloat16)Li(\d)E", entry)
        if m:
            out[f"h{m.group(2)}_generic_{_DTYPE_NAMES[m.group(1)]}{_compute_tag(entry)}"] = r
    return out


def _computes():
    """(compute dtype, key suffix) of the two instances, one a policy, that
    every instance code of every kernel has."""
    import torch

    return ((torch.float32, ""), (torch.bfloat16, BF16C))


def phase_build() -> dict:
    """Build every source; print the compiler's report and each source's
    build seconds, each stream, direct and fused instance's shared memory,
    registers, spills and resident blocks per SM (fp32 and bf16 compute);
    fails where a generic stream instance holds under two fp32 blocks an
    SM or spills, or a generic fused one under three or spills. Returns
    those, keyed ``k<k>_<instance>_<dtype>`` (stream),
    ``h<halo>_<instance>_<dtype>`` (direct) and
    ``fused_h<halo>_<instance>_<dtype>``, + ``BF16C`` for a bf16-compute
    instance."""
    import torch

    from heat3d_tpu_torch.ops import _build
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    seconds = _build.build_all()
    _say("build", seconds=seconds)
    for name in seconds:
        print(_build.build_log(name).strip(), flush=True)
    spills = ("registers", "spill_stores", "spill_loads")
    ptxas = _stream_ptxas()
    _check(len(ptxas) == 48, f"compiler report of the stream instances: {sorted(ptxas)}")
    resources = {}
    for k in (1, *ss.STREAMK_DEPTHS):
        for code in (ss.GENERIC, *ss.CHAINS):
            for dtype in (torch.float32, torch.bfloat16):
                for cd, tag in _computes():
                    key = f"k{k}_{_instance_name(code)}_{str(dtype)[6:]}{tag}"
                    resources[key] = {**ss.instance_resources(k, code, dtype, cd),
                                      **{f: ptxas.get(key, {}).get(f) for f in spills[1:]}}
                    _check(resources[key]["blocks_per_sm"] > 0,
                           f"stream instance {key} fits no SM: {resources[key]}")
                    # the generic sweep's budget: two fp32 blocks an SM at
                    # every depth, no spills
                    _check(code != ss.GENERIC or (
                        (dtype != torch.float32 or resources[key]["blocks_per_sm"] >= 2)
                        and resources[key]["spill_stores"] == 0),
                        f"generic stream instance {key} over its budget: {resources[key]}")
    _say("build", stream_instances=resources)
    ptxas = _direct_ptxas()
    direct = {}
    for h in (1, 2):
        for code in (ss.GENERIC, *ss.CHAINS, sd.MEHRSTELLEN):
            for dtype in (torch.float32, torch.bfloat16):
                for cd, tag in _computes():
                    key = f"h{h}_{_instance_name(code)}_{str(dtype)[6:]}{tag}"
                    direct[key] = {**sd.instance_resources(h, code, dtype, cd),
                                   **{f: ptxas.get(key, {}).get(f) for f in spills[1:]}}
                    _check(direct[key]["blocks_per_sm"] > 0,
                           f"direct instance {key} fits no SM: {direct[key]}")
    _check(len(ptxas) == 32, f"compiler report of the direct instances: {sorted(ptxas)}")
    _say("build", direct_instances=direct)
    resources.update(direct)
    ptxas = _fused_ptxas()
    fused = {}
    for h in (1, 2):
        for code in (ss.GENERIC, *ss.CHAINS):
            for dtype in (torch.float32, torch.bfloat16):
                for cd, tag in _computes():
                    key = f"h{h}_{_instance_name(code)}_{str(dtype)[6:]}{tag}"
                    fused[key] = {**fd.instance_resources(h, code, dtype, cd),
                                  **{f: ptxas.get(key, {}).get(f) for f in spills[1:]}}
                    _check(fused[key]["blocks_per_sm"] > 0,
                           f"fused instance {key} fits no SM: {fused[key]}")
                    # the generic sweep's budget: three fp32 blocks an SM
                    # (cooperative residency: every block of the grid), no
                    # spills
                    _check(code != ss.GENERIC or (
                        (dtype != torch.float32 or fused[key]["blocks_per_sm"] >= 3)
                        and fused[key]["spill_stores"] == 0),
                        f"generic fused instance {key} over its budget: {fused[key]}")
    _check(len(ptxas) == 24, f"compiler report of the fused instances: {sorted(ptxas)}")
    _say("build", fused_instances=fused)
    resources.update({f"fused_{k}": v for k, v in fused.items()})
    return resources


def _one_shard_plan(u, periodic, k):
    """The width-k exchange plan the solver runs on a (1,1,1) mesh of ``u``
    on cuda:0."""
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    return ExchangePlan(_card_mesh((1, 1, 1), tuple(u.shape)), _bc(periodic), k,
                        "ppermute", u.dtype)


def _padded(u, periodic, bcv, k):
    """``u``'s width-k padded block, made by the solver's (1,1,1) plan."""
    return _one_shard_plan(u, periodic, k).apply([u], bcv)[0]


def _kernel_input(name, u, periodic, bcv, k):
    """What ``name``'s kernel reads: the field itself for the direct
    kernels, its width-k halo exchange for the exchange-path kernels."""
    if name in ("apply_taps_direct", "apply_taps_direct2"):
        return u
    return _padded(u, periodic, bcv, k)


def _kernel_pair(name, k, edges=(True,) * 6, cd=None):
    """``name``'s kernel and its plain version, both called as
    ``f(x, taps, periodic, bc_value)`` on ``_kernel_input``'s ``x`` (the
    kernel also takes ``out=``) in compute dtype ``cd`` (default float32);
    streamk with the domain-edge mask ``edges`` (default: a whole-domain
    block's)."""
    import torch

    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss
    from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded

    cd = cd or torch.float32
    if name in ("apply_taps_direct", "apply_taps_direct2"):
        kern = getattr(sd, name)
        ref = getattr(sd, name + "_ref")
        return (lambda x, t, p, b, out=None: kern(x, t, p, b, out=out, compute_dtype=cd),
                lambda x, t, p, b: ref(x, t, p, b, cd))
    if name == "apply_taps_stream":
        return (lambda x, t, p, b, out=None: ss.apply_taps_stream(x, t, out=out,
                                                                  compute_dtype=cd),
                lambda x, t, p, b: apply_taps_padded(x, t, compute_dtype=cd))
    return (lambda x, t, p, b, out=None: ss.apply_taps_streamk(x, t, k, p, b, out=out,
                                                               edges=edges, compute_dtype=cd),
            lambda x, t, p, b: ss.apply_taps_streamk_ref(x, t, k, p, b, edges, cd))


def _run_kernel(name, u, taps, periodic, bcv, k=1, cd=None):
    """(kernel output, plain output) of ``name`` on field ``u`` in compute
    dtype ``cd``."""
    kern, plain = _kernel_pair(name, k, cd=cd)
    x = _kernel_input(name, u, periodic, bcv, k)
    return kern(x, taps, periodic, bcv), plain(x, taps, periodic, bcv)


def _cases():
    """(kernel name, k) of every kernel instance."""
    from heat3d_tpu_torch.ops.stencil_stream import STREAMK_DEPTHS

    return ([("apply_taps_direct", 1), ("apply_taps_direct2", 2), ("apply_taps_stream", 1)]
            + [("apply_taps_streamk", k) for k in STREAMK_DEPTHS])


def _max_err(got, want) -> float:
    """max |got - want| over the cells that differ (equal infinities differ
    by 0, a NaN against a number by inf)."""
    import torch

    g, w = got.float(), want.float()
    d = torch.where(g == w, torch.zeros_like(g), (g - w).abs())
    return float(d.nan_to_num(nan=float("inf")).max())


def _hold(worst: dict, name: str, got, want, what: str) -> None:
    """Fail unless kernel output ``got`` equals plain output ``want``
    bitwise; fold |got - want| into ``worst[name]``."""
    import torch

    torch.cuda.synchronize()
    err = _max_err(got, want)
    worst[name] = max(worst[name], err)
    _check(torch.equal(got, want), f"{name} != plain {what}: max err {err}")


def phase_compare(worst: dict) -> None:
    """Each kernel against its plain version on the card, bitwise, folding
    the largest |kernel - plain| of each kernel into ``worst``; the
    streamk plain version against k direct launches; and the exchange-path
    solve against the direct-path solve."""
    import numpy as np
    import torch

    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    n = chained = 0
    for shape in ((33, 17, 129), (64, 72, 200), (128, 128, 128), (256, 256, 256)):
        base = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                for periodic, bcv in _BCS:
                    what = f"at {shape} {dtype} {kind} periodic={periodic} bc={bcv}"
                    for name, k in _cases():
                        got, want = _run_kernel(name, u, taps, periodic, bcv, k)
                        _hold(worst, name, got, want, f"k={k} {what}")
                        n += 1
                    for k in ss.STREAMK_DEPTHS:
                        want = u
                        for _ in range(k):
                            want = sd.apply_taps_direct(want, taps, periodic, bcv)
                        got = ss.apply_taps_streamk_ref(
                            _padded(u, periodic, bcv, k), taps, k, periodic, bcv)
                        torch.cuda.synchronize()
                        _check(torch.equal(got, want),
                               f"streamk plain != {k} direct launches {what}")
                        chained += 1
            del u
        torch.cuda.empty_cache()
    direct = _compare_direct(worst)
    generic = _compare_generic(worst)
    stream_generic = _compare_stream_generic(worst)
    solves = 0
    for k in (1, 2, 3, 4):
        for kind in ("7pt", "27pt"):
            for storage in ("float32", "bfloat16"):
                for periodic, bcv in ((False, 0.3), (True, 0.0)):
                    want = _solve_gathered(128, (1, 1, 1), kind, storage, periodic, bcv, 1, k)
                    got = _solve_gathered(128, (1, 1, 1), kind, storage, periodic, bcv, k, k,
                                          no_direct=True)
                    _check(got.tobytes() == want.tobytes(),
                           f"exchange-path solve != direct solve: k={k} {kind} "
                           f"{storage} periodic={periodic}")
                    solves += 1
    _say("compare", cases=n, bitwise=True, max_abs_err=worst,
         streamk_plain_vs_direct_launches=chained, exchange_vs_direct_solves=solves,
         direct_instances=direct, generic_instance=generic,
         stream_generic_cases=stream_generic, launches=ops.launch_counts())


# the direct kernels' ragged shapes: nx below 2H+1, odd nz, y and z no
# multiple of the compile-time tiles (38 x 62 at halo 1, 28 x 60 at halo 2),
# several tiles each way, and nx = 1024 (x cut into chunks); with the
# x-chunk forced to 3 planes on (40, 70, 65)
_DIRECT_SHAPES = ((1, 1, 1), (2, 3, 5), (4, 45, 130), (5, 77, 125), (6, 39, 127),
                  (1024, 257, 131))
_DIRECT_FORCED_CHUNK = ((40, 70, 65), 3)
# ragged shapes of the Mehrstellen two-update instance's 28 x 28 tiles and
# its rows owned in runs of four: y and z of one tile exactly and one more,
# of one run, of two tiles and one, a run short of the 32-row frame
_QR_SHAPES = ((5, 28, 28), (4, 29, 29), (6, 4, 33), (3, 57, 57), (7, 31, 64), (2, 30, 35))


def _special_field(shape, seed):
    """A normal field with the edges of the bf16 format in it: float32 and
    bf16 subnormals scattered and in a block whose outputs stay subnormal,
    values whose products underflow to subnormals, signed zeros, and, in
    two x slabs nine planes apart (periodic wrap included), +inf with the
    largest finite values (whose sums overflow) and their negatives: no two
    infinities of opposite sign within reach of each other over four
    updates, so no NaN (tests/test_torch_kernels.py takes it from here)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)
    cells = rng.random(shape)
    tiny = cells < 0.15
    u[tiny] = rng.choice(np.float32([1e-39, -1e-39, 3e-41, -3e-41, 1e-45]), size=int(tiny.sum()))
    u[(cells >= 0.15) & (cells < 0.2)] = np.float32(1.2e-37)
    u[(cells >= 0.2) & (cells < 0.25)] = np.float32(0.0)
    u[(cells >= 0.25) & (cells < 0.3)] = np.float32(-0.0)
    u[10:13, :20, :40] = rng.choice(np.float32([1e-39, 3e-41, 2e-39]), size=(3, 20, 40))
    hot = np.zeros(shape, dtype=bool)
    hot[3:7] = rng.random((4,) + tuple(shape[1:])) < 0.05
    u[hot] = rng.choice(np.float32([np.inf, 3.0e38, 2.9e38]), size=int(hot.sum()))
    cold = np.zeros(shape, dtype=bool)
    cold[16:20] = rng.random((4,) + tuple(shape[1:])) < 0.05
    u[cold] = rng.choice(np.float32([-np.inf, -3.0e38]), size=int(cold.sum()))
    return u


def _generic_counts() -> dict:
    """Launches that took the generic instance, per kernel wrapper (the
    one-update fused wrappers too)."""
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
    from heat3d_tpu_torch.ops import stencil_stream as ss

    return {**sd.generic_launch_counts(), **ss.generic_launch_counts(),
            **fd.generic_launch_counts(), **fr.generic_launch_counts()}


def _hold_instance(worst, name, u, taps, periodic, bcv, k, what, chunk=None) -> None:
    """``name`` on ``u`` bitwise against its plain version, on the instance
    ``stream_instance`` names (the wrapper's generic count says which ran);
    ``chunk`` forces the direct kernels' x-chunk to that many planes."""
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    code = ss.stream_instance(taps)
    before = _generic_counts()[name]
    if chunk is None:
        got, want = _run_kernel(name, u, taps, periodic, bcv, k)
    else:
        got = sd.launch_instance(k, sd.direct_instance(taps), u, taps, periodic, bcv,
                                 xchunk=chunk)
        want = _kernel_pair(name, k)[1](u, taps, periodic, bcv)
    _hold(worst, name, got, want, what)
    took = _generic_counts()[name] - before
    _check(took == (code == ss.GENERIC),
           f"{name} {what}: generic launches {took}, instance {_instance_name(code)}")


def _compare_direct(worst: dict) -> int:
    """The direct kernels (halo 1 and 2) at ``_DIRECT_SHAPES`` and a forced
    multi-chunk case, 7pt/27pt x fp32/bf16 x Dirichlet bc 0 and 0.3 and
    periodic, bitwise against their plain versions on the instance
    ``stream_instance`` names. Returns the number of cases."""
    import numpy as np
    import torch

    cases = 0
    shapes = [(shape, None) for shape in _DIRECT_SHAPES] + [_DIRECT_FORCED_CHUNK]
    for shape, chunk in shapes:
        base = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                for periodic, bcv in _BCS:
                    for name, k in _cases()[:2]:
                        _hold_instance(worst, name, u, taps, periodic, bcv, k,
                                       f"at {shape} chunk {chunk} {dtype} {kind} "
                                       f"periodic={periodic} bc={bcv}", chunk)
                        cases += 1
            del u
        torch.cuda.empty_cache()
    return cases


# the factoring knobs of the compare phase's generic-instance cases
_KNOBS = ({"HEAT3D_FACTOR_7PT": "1"}, {"HEAT3D_FACTOR_Y": "0"},
          {"HEAT3D_FACTOR_7PT": "1", "HEAT3D_FACTOR_Y": "0"})


def _compare_generic(worst: dict) -> dict:
    """Every stencil kernel (direct1, direct2, the stream kernel and streamk
    at k = 2..4, and the one- and two-update fused kernels over (4,1,1)) at 128^3
    under the factoring knobs, 7pt/27pt x fp32/bf16 x three boundary
    settings (fused: Dirichlet 0.3 and periodic), bitwise against its plain
    version; each launch must take the instance ``stream_instance`` names
    (the generic one exactly where the emission program is not a ``CHAINS``
    entry), counted by the wrappers."""
    import numpy as np
    import torch

    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    base = np.random.default_rng(9).standard_normal((128, 128, 128)).astype(np.float32)
    mesh = _card_mesh((4, 1, 1), (32, 128, 128))
    cases = {}
    for knobs in _KNOBS:
        with _env(**knobs):
            for dtype in (torch.float32, torch.bfloat16):
                u = torch.from_numpy(base).cuda().to(dtype)
                us = _split(u, mesh)
                for kind in ("7pt", "27pt"):
                    taps = _taps(kind)
                    code = ss.stream_instance(taps)
                    tag = f"{'+'.join(f'{k}={v}' for k, v in knobs.items())} {kind}"
                    cases[tag] = _instance_name(code)
                    for periodic, bcv in _BCS:
                        for name, k in _cases():
                            _hold_instance(worst, name, u, taps, periodic, bcv, k,
                                           f"k={k} at 128^3 {dtype} {tag} "
                                           f"periodic={periodic} bc={bcv}")
                    for (periodic, bcv), name in itertools.product(
                            ((False, 0.3), (True, 0.0)),
                            ("apply_step_fused_dma", "apply_superstep_fused_dma")):
                        kern, plain = _fused_pair(name)
                        before = _generic_counts()[name]
                        state = fd.FusedState(mesh, _FUSED[name][0], dtype, periodic)
                        got = kern(us, taps, mesh, state, periodic, bcv)
                        _hold_fused(worst, name, got, plain(us, taps, mesh, None, periodic, bcv),
                                    f"128^3 on (4,1,1) {dtype} {tag} periodic={periodic}")
                        took = _generic_counts()[name] - before
                        _check(took == (code == ss.GENERIC),
                               f"{name} {tag}: generic launches {took}, instance "
                               f"{_instance_name(code)}")
                del u, us
    return cases


# the stream kernels' generic battery: interiors below 2k+1, odd nz, y and z
# no multiple of the tiles (38 x 62 at k = 1 .. 24 x 56 at k = 4), several
# tiles each way; Dirichlet edge masks of the whole domain, an interior
# shard and a mixed one
_STREAM_GENERIC_SHAPES = ((2, 3, 5), (5, 77, 125), (33, 17, 129))
_STREAM_EDGES = ((True,) * 6, (False,) * 6, (True, False, False, True, True, False))


def _stream_generic_programs() -> dict:
    """Programs of no ``CHAINS`` entry outside the factoring knobs: the
    registry's advection-diffusion at vx=2 (six terms, no x+1 tap), heat 7pt
    with a zero centre, a 27pt set without its x and y symmetries and a
    random 27-term set (x-1 and x+1 read away from the cell)."""
    import numpy as np

    zc, asym = _taps("7pt"), _taps("27pt")
    zc[1, 1, 1] = 0.0
    asym[0, 0, 0] *= 1.5
    asym[2, 1, 0] *= 0.7
    return {"advection": _advection_taps(8), "zero-centre": zc, "asym27": asym,
            "random27": np.random.default_rng(4).uniform(-0.1, 0.1, (3, 3, 3))}


def _hold_nan(worst: dict, name: str, got, want, what: str) -> None:
    """``_hold`` with NaN in the same cells of both counting as equal (a
    random program's mixed signs meet infinities of both signs)."""
    import torch

    torch.cuda.synchronize()
    nan = want.isnan()
    _check(torch.equal(got.isnan(), nan), f"{name} != plain {what}: NaN in other cells")
    _hold(worst, name, got.masked_fill(nan, 0), want.masked_fill(nan, 0), what)


def _compare_stream_generic(worst: dict) -> int:
    """The stream kernel and streamk k = 2..4 on the generic instance,
    forced (``ss.launch_instance(k, 0, ...)``) on each program of
    ``_stream_generic_programs``: random padded blocks of
    ``_STREAM_GENERIC_SHAPES`` and the special-value field, the wrapper's
    x-chunk and chunks of 3 and 1 planes, fp32/bf16 storage x fp32/bf16
    compute x Dirichlet bc 0 and 0.3 under ``_STREAM_EDGES`` and periodic,
    each bitwise against its plain version and counted on the generic
    instance. Returns the number of cases."""
    import numpy as np
    import torch

    from heat3d_tpu_torch.ops import stencil_stream as ss

    rng = np.random.default_rng(16)
    dtypes = (torch.float32, torch.bfloat16)
    cases = 0
    for prog, taps in _stream_generic_programs().items():
        _check(ss.stream_instance(taps) == ss.GENERIC, f"{prog} is a CHAINS program")
        for k in (1, *ss.STREAMK_DEPTHS):
            name = "apply_taps_stream" if k == 1 else "apply_taps_streamk"
            pads = [tuple(m + 2 * k for m in shape) for shape in _STREAM_GENERIC_SHAPES]
            fields = [rng.standard_normal(p).astype(np.float32) for p in pads]
            fields.append(_special_field((24 + 2 * k, 33 + 2 * k, 70 + 2 * k), 5))
            for base, dtype, cd in itertools.product(fields, dtypes, dtypes):
                up = torch.from_numpy(base).cuda().to(dtype)
                for periodic, bcv in _BCS:
                    for edges in _STREAM_EDGES if k > 1 and not periodic else _STREAM_EDGES[:1]:
                        want = _kernel_pair(name, k, edges, cd)[1](up, taps, periodic, bcv)
                        for chunk in (None, 3, 1):
                            before = _generic_counts()[name]
                            got = ss.launch_instance(k, ss.GENERIC, up, taps, periodic, bcv,
                                                     edges=edges, xchunk=chunk,
                                                     compute_dtype=cd)
                            _hold_nan(worst, name, got, want,
                                      f"generic {prog} k={k} {tuple(base.shape)} {dtype} "
                                      f"compute {cd} periodic={periodic} bc={bcv} "
                                      f"edges={edges} chunk={chunk}")
                            _check(_generic_counts()[name] == before + 1,
                                   f"{name} {prog}: not counted on the generic instance")
                            cases += 1
                del up
    torch.cuda.empty_cache()
    return cases


def _card_mesh(shape, local, devices=None):
    """A ShardMesh of ``shape`` over ``local`` blocks, every shard on
    ``cuda:0`` (or on ``devices``), each on a stream of its own."""
    import torch

    from heat3d_tpu_torch.parallel.topology import ShardMesh

    n = shape[0] * shape[1] * shape[2]
    return ShardMesh(shape, local, devices or [torch.device("cuda", 0)] * n)


def _split(u, mesh):
    """The shards of global field ``u``, each on its shard's device."""
    return [u[tuple(slice(o, o + n) for o, n in zip(s.origin, mesh.local_shape))]
            .contiguous().to(s.device) for s in mesh.shards]


def _exchange_pair(mesh, us, periodic, bcv, width, dtype):
    """(DMA kernels' padded blocks, plain version's padded blocks) of one
    exchange of the shards ``us``: the plain version does every DMA axis
    with the slab copies of ``exchange_axis_dma_ref`` (the ppermute
    transport)."""
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    got = ExchangePlan(mesh, _bc(periodic), width, "dma", dtype)
    want = ExchangePlan(mesh, _bc(periodic), width, "ppermute", dtype)
    mesh.fork()
    a, b = got.apply(us, bcv), want.apply(us, bcv)
    mesh.join()
    return a, b


def _hold_blocks(worst, got, want, what):
    import torch

    from heat3d_tpu_torch.ops import halo_dma

    torch.cuda.synchronize()
    halo_dma.raise_if_timed_out()
    for g, w in zip(got, want):
        _hold(worst, "halo_dma", g, w, what)


def _dma_burst(worst, mesh, base_us, periodic, bcv, width, n=50):
    """``n`` DMA exchanges in a row on one plan (epochs 1..n on the same
    flag words), each shard's new input made and its padded block copied
    out on the shard's own stream, with no host synchronisation between
    them; then each held to the plain version."""
    import torch

    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    plan = ExchangePlan(mesh, _bc(periodic), width, "dma", torch.float32)
    snaps = []
    mesh.fork()
    for i in range(n):
        us = []
        for s, b in zip(mesh.shards, base_us):
            with mesh.on(s):
                us.append(b + i)
        pads = plan.apply(us, bcv)
        snap = []
        for s, p in zip(mesh.shards, pads):
            with mesh.on(s):
                snap.append(p.clone())
        snaps.append(snap)
    mesh.join()
    ref = ExchangePlan(mesh, _bc(periodic), width, "ppermute", torch.float32)
    for i, snap in enumerate(snaps):
        mesh.fork()
        want = ref.apply([b + i for b in base_us], bcv)
        mesh.join()
        _hold_blocks(worst, snap, want, f"exchange {i + 1} of {n} on {mesh.shape} "
                     f"width {width} periodic={periodic}")
    return n


def _solve_gathered(n, mesh, kind, storage, periodic, bcv, tb, steps, halo="ppermute",
                    no_direct=False, device=None, **knobs):
    """The host field after ``steps`` updates of a random initial field."""
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    cfg = SolverConfig(
        grid=GridConfig(shape=n if isinstance(n, tuple) else (n, n, n)),
        stencil=StencilConfig(kind=kind, bc=_bc(periodic), bc_value=bcv),
        mesh=MeshConfig(shape=mesh), halo=halo,
        precision=Precision(storage=storage), time_blocking=tb, **knobs,
    )
    with _no_direct(no_direct):
        solver = HeatSolver3D(cfg, device=device)
        return solver.gather(solver.run(solver.init_state("random"), steps))


# (halo, time_blocking, HEAT3D_NO_DIRECT, stencil, storage, periodic) of the
# sharded-vs-(1,1,1) solves
_SHARDED_SOLVES = (
    ("ppermute", 1, False, "7pt", "float32", False),
    ("ppermute", 2, False, "7pt", "float32", False),
    ("ppermute", 3, False, "7pt", "float32", False),
    ("ppermute", 4, False, "7pt", "float32", False),
    ("ppermute", 1, True, "7pt", "float32", False),
    ("dma", 1, False, "7pt", "float32", False),
    ("dma", 2, False, "7pt", "float32", False),
    ("dma", 4, False, "7pt", "float32", False),
    ("ppermute", 2, False, "7pt", "float32", True),
    ("dma", 4, False, "7pt", "float32", True),
    ("ppermute", 2, False, "27pt", "bfloat16", False),
    ("dma", 4, False, "27pt", "bfloat16", False),
)


def phase_compare_mesh(worst: dict) -> None:
    """The DMA kernels and the edge-masked streamk against their plain
    versions, and the sharded solve against the (1,1,1) solve, bitwise,
    every shard on cuda:0 on its own stream."""
    import numpy as np
    import torch

    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.ops import stencil_stream as ss
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    t0 = time.perf_counter()
    cases = bursts = 0
    for shape in ((66, 34, 258), (128, 128, 128)):
        base = torch.from_numpy(
            np.random.default_rng(3).standard_normal(shape).astype(np.float32)).cuda()
        for mesh_shape in _DMA_MESHES:
            mesh = _card_mesh(mesh_shape, tuple(g // p for g, p in zip(shape, mesh_shape)))
            for dtype in (torch.float32, torch.bfloat16):
                us = _split(base.to(dtype), mesh)
                for periodic, bcv in _BCS:
                    for width in (1, 2, 3, 4):
                        got, want = _exchange_pair(mesh, us, periodic, bcv, width, dtype)
                        _hold_blocks(worst, got, want,
                                     f"at {shape} mesh {mesh_shape} {dtype} width {width} "
                                     f"periodic={periodic} bc={bcv}")
                        cases += 1
            if shape == (128, 128, 128):
                us = _split(base, mesh)
                bursts += _dma_burst(worst, mesh, us, False, 0.3, 1)
                bursts += _dma_burst(worst, mesh, us, True, 0.0, 4)
        del base
    torch.cuda.empty_cache()

    # streamk's domain-edge mask: every shard of a (3,3,3) mesh, the centre
    # one interior on all six sides
    masked = 0
    mesh = _card_mesh((3, 3, 3), (32, 32, 32))
    base = torch.from_numpy(
        np.random.default_rng(8).standard_normal((96, 96, 96)).astype(np.float32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        us = _split(base.to(dtype), mesh)
        for kind in ("7pt", "27pt"):
            taps = _taps(kind)
            for k in ss.STREAMK_DEPTHS:
                for bcv in (0.0, 0.3):
                    plan = ExchangePlan(mesh, _bc(False), k, "ppermute", dtype)
                    mesh.fork()
                    pads = plan.apply(us, bcv)
                    mesh.join()
                    for s in mesh.shards:
                        got = ss.apply_taps_streamk(pads[s.rank], taps, k, False, bcv,
                                                    edges=s.edges)
                        want = ss.apply_taps_streamk_ref(pads[s.rank], taps, k, False, bcv,
                                                         s.edges)
                        _hold(worst, "apply_taps_streamk", got, want,
                              f"k={k} {kind} {dtype} bc={bcv} shard {s.coords} edges {s.edges}")
                        masked += 1
    del base, us, pads
    torch.cuda.empty_cache()

    solves = []
    for halo, tb, no_direct, kind, storage, periodic in _SHARDED_SOLVES:
        bcv = 0.0 if periodic else 0.3
        want = _solve_gathered(128, (1, 1, 1), kind, storage, periodic, bcv, 1, 20)
        got = _solve_gathered(128, _MESH, kind, storage, periodic, bcv, tb, 20, halo,
                              no_direct, device="cuda:0")
        _check(got.tobytes() == want.tobytes(),
               f"sharded solve != (1,1,1) solve: halo={halo} tb={tb} no_direct={no_direct} "
               f"{kind} {storage} periodic={periodic}: max err "
               f"{float(np.abs(got - want).max())}")
        solves.append([halo, tb, no_direct, kind, storage, periodic])
    _say("compare_mesh", dma_cases=cases, dma_exchanges_in_a_row=bursts,
         streamk_masked_cases=masked, sharded_vs_single_solves=solves, bitwise=True,
         max_abs_err=worst, launches=ops.launch_counts(),
         seconds=time.perf_counter() - t0)


# (stencil, time_blocking, HEAT3D_NO_DIRECT) of the golden phase, with the
# kernel each must launch
_GOLDEN = (
    (1, False, "apply_taps_direct"), (2, False, "apply_taps_direct2"),
    (3, False, "apply_taps_streamk"), (4, False, "apply_taps_streamk"),
    (1, True, "apply_taps_stream"), (2, True, "apply_taps_streamk"),
)


# (grid, halo, time_blocking, bc value, kernel it must launch) of the
# golden phase's sharded runs, on a (2,2,2) mesh on cuda:0
_GOLDEN_SHARDED = (
    (128, "ppermute", 1, 0.0, "apply_taps_direct"),
    (128, "ppermute", 2, 0.0, "apply_taps_direct2"),
    (128, "ppermute", 4, 0.0, "apply_taps_streamk"),
    (128, "dma", 1, 0.0, "halo_dma"),
    (128, "dma", 4, 0.0, "halo_dma"),
)
# uneven: 129^3 over (2,2,2) stores 130^3 with bc-pinned padding
_GOLDEN_UNEVEN = ((129, "ppermute", 1, 0.3, "apply_taps_stream"),
                  (129, "dma", 4, 0.3, "halo_dma"))


def _golden_cli(argv, want, **tags) -> None:
    from heat3d_tpu_torch import cli

    if "--mesh" not in argv:
        # one shard, whatever the count of visible GPUs the default takes
        argv = argv + ["--mesh", "1", "1", "1"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--golden-check"])
    _check(rc == 0, f"solver CLI {argv} exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    _check(summary["golden_pass"], f"golden check failed: {summary}")
    _check(summary["kernel_launches"][want] > 0, f"{want} not launched: {summary}")
    _say("golden", **tags, steps=summary["steps"], golden_pass=summary["golden_pass"],
         golden_rel_err=summary["golden_rel_err"],
         step_route=summary["step_route"], superstep_route=summary["superstep_route"],
         kernel_launches=summary["kernel_launches"])


# (mesh, extra flags, time_blocking, HEAT3D_NO_DIRECT, kernel it must launch)
# of the golden phase's overlap-route runs on cuda:0; the partitioned runs
# with HEAT3D_PLAN_PART_MIN_BYTES=0, so a 128^3 face ships as sub-blocks
_GOLDEN_FUSED = (
    ((8, 1, 1), ["--halo", "dma", "--overlap"], 1, False, "apply_step_fused_dma"),
    ((8, 1, 1), ["--halo", "dma", "--overlap"], 2, False, "apply_superstep_fused_dma"),
    ((2, 2, 2), ["--halo", "dma", "--overlap"], 1, False, "apply_step_fused_dma"),
    ((4, 1, 1), ["--fused-rdma", "on", "--halo-plan", "partitioned"], 1, False,
     "apply_step_fused_rdma"),
    ((4, 1, 1), ["--fused-rdma", "on", "--halo-plan", "partitioned"], 2, False,
     "apply_superstep_fused_rdma"),
    ((2, 2, 2), ["--overlap"], 1, True, "apply_taps_stream"),
)


@contextlib.contextmanager
def _env(**kw):
    """Set environment variables for the block."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _golden_native() -> None:
    """The fp64 oracle itself: the OpenMP stepper (``native``) must build on
    the card's host, and at 128^3 it is timed beside NumPy on the same
    field (one 7pt and one 27pt case, 20 steps), the two within 1e-13."""
    import numpy as np

    from heat3d_tpu_torch import native
    from heat3d_tpu_torch.core import golden
    from heat3d_tpu_torch.core.config import GridConfig, StencilConfig

    _check(native.available(), f"native stepper did not build: {native.build_error()}")
    grid = GridConfig.cube(128)
    u0 = golden.make_init("hot-cube", (128, 128, 128)).astype(np.float64)
    for kind in ("7pt", "27pt"):
        st = StencilConfig(kind=kind)
        t0 = time.perf_counter()
        a = golden.run(u0, grid, st, 20, impl="native")
        t1 = time.perf_counter()
        b = golden.run(u0, grid, st, 20, impl="numpy")
        t2 = time.perf_counter()
        err = float(np.abs(a - b).max())
        _check(err <= 1e-13 * max(1.0, float(np.abs(b).max())),
               f"native golden {kind} differs from NumPy by {err}")
        _say("golden_native", grid=128, stencil=kind, steps=20, native_s=t1 - t0,
             numpy_s=t2 - t1, numpy_over_native=(t2 - t1) / (t1 - t0),
             bitwise=a.tobytes() == b.tobytes(), max_abs_diff=err,
             threads=os.cpu_count())


def phase_golden() -> None:
    # the CLI's --golden-check runs golden.run(impl='auto'): the native
    # stepper, asserted available here
    _golden_native()
    for kind in ("7pt", "27pt"):
        for tb, no_direct, want in _GOLDEN:
            with _no_direct(no_direct):
                _golden_cli(["--grid", "128", "--steps", "20", "--stencil", kind,
                             "--time-blocking", str(tb)], want,
                            stencil=kind, time_blocking=tb, no_direct=no_direct)
    for kind in ("7pt", "27pt"):
        for n, halo, tb, bcv, want in _GOLDEN_SHARDED + (
                _GOLDEN_UNEVEN if kind == "7pt" else ()):
            _golden_cli(["--grid", str(n), "--steps", "20", "--stencil", kind,
                         "--time-blocking", str(tb), "--mesh", *map(str, _MESH),
                         "--halo", halo, "--bc-value", str(bcv), "--device", "cuda:0"],
                        want, grid=n, stencil=kind, mesh=list(_MESH), halo=halo,
                        time_blocking=tb, bc_value=bcv)
    for kind in ("7pt", "27pt"):
        for mesh, flags, tb, no_direct, want in _GOLDEN_FUSED:
            with _no_direct(no_direct), _env(HEAT3D_PLAN_PART_MIN_BYTES="0"):
                _golden_cli(["--grid", "128", "--steps", "20", "--stencil", kind,
                             "--time-blocking", str(tb), "--mesh", *map(str, mesh), *flags,
                             "--device", "cuda:0"],
                            want, grid=128, stencil=kind, mesh=list(mesh), flags=flags,
                            time_blocking=tb, no_direct=no_direct)


# (stencil, time_blocking, storage, HEAT3D_NO_DIRECT) of the full-width phase
_FULL_WIDTH = (
    ("7pt", 2, "float32", False), ("7pt", 1, "float32", False),
    ("27pt", 2, "float32", False), ("7pt", 2, "bfloat16", False),
    ("7pt", 4, "float32", False), ("7pt", 3, "float32", False),
    ("7pt", 1, "float32", True), ("27pt", 4, "float32", False),
    ("7pt", 4, "bfloat16", False),
)
# the tb=2 headline's Gcell/s of this run's main path (the tune phase's reference)
_MAIN_PATH_TB2 = []
# every bench row the full-width and halo phases wrote (the lint phase runs
# the provenance lint and bench.report over them)
_BENCH_ROWS = []
# (halo, time_blocking) of the full-width phase's sharded rows: fp32 7pt on
# a (2,2,2) mesh of 512^3 shards, every shard on cuda:0
_SHARDED_FULL_WIDTH = (("dma", 1), ("dma", 4), ("ppermute", 1), ("ppermute", 2))
# (mesh, knobs, time_blocking, HEAT3D_NO_DIRECT) of the full-width phase's
# overlap-route rows: fp32 7pt, every shard on cuda:0
_FUSED_FULL_WIDTH = (
    ((8, 1, 1), {"halo": "dma", "overlap": True}, 1, False),
    ((8, 1, 1), {"halo": "dma", "overlap": True}, 2, False),
    ((2, 2, 2), {"halo": "dma", "overlap": True}, 1, False),
    ((4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, 1, False),
    ((4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, 2, False),
    ((2, 2, 2), {"overlap": True}, 1, True),
)


def phase_full_width(bw: float) -> None:
    import torch

    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    n = 1024
    for kind, tb, storage, no_direct in _FULL_WIDTH:
        cfg = SolverConfig(
            grid=GridConfig.cube(n), stencil=StencilConfig(kind=kind),
            precision=Precision(storage=storage), time_blocking=tb,
        )
        with _no_direct(no_direct):
            row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3)
        route = row["superstep_route"] if tb > 1 else row["step_route"]
        itemsize = torch.empty((), dtype=getattr(torch, storage)).element_size()
        b_ms, by = superstep_bound(route, n, tb, itemsize, flops_per_update(_taps(kind)), bw)
        _check(sum(row["kernel_launches"].values()) > 0, f"no launches: {row}")
        if (kind, tb, storage, no_direct) == ("7pt", 2, "float32", False):
            _MAIN_PATH_TB2.append(row["gcell_updates_per_sec"])
        _say("full_width", grid=row["grid"], stencil=kind, dtype=storage,
             time_blocking=tb, no_direct=no_direct, route=route,
             steps=row["steps"], gcell_updates_per_sec=row["gcell_updates_per_sec"],
             ms_per_superstep=row["ms_per_launch"],
             cost_redundant_flops_frac=row["cost_redundant_flops_frac"],
             bound_ms_per_superstep=b_ms, bound_by=by,
             bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
             kernel_launches=row["kernel_launches"], seconds_all=row["seconds_all"])
        _BENCH_ROWS.append(dict(row))
        del row
        torch.cuda.empty_cache()

    for halo, tb in _SHARDED_FULL_WIDTH:
        cfg = SolverConfig(grid=GridConfig.cube(n), mesh=MeshConfig(shape=_MESH),
                           halo=halo, time_blocking=tb)
        row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3,
                               device="cuda:0")
        route = row["superstep_route"] if tb > 1 else row["step_route"]
        b_ms, by, b_bytes = sharded_superstep_bound(
            route, n, _MESH, tb, 4, flops_per_update(_taps("7pt")), bw)
        _check(row["kernel_launches"].get("halo_dma", 0) > 0 or halo != "dma",
               f"no DMA launches: {row}")
        ex_ms = _exchange_ms(cfg, route)
        _say("full_width", grid=row["grid"], stencil="7pt", dtype="float32",
             mesh=row["mesh"], halo=halo, shards_per_device=row["shards_per_device"],
             time_blocking=tb, route=route, steps=row["steps"],
             gcell_updates_per_sec=row["gcell_updates_per_sec"],
             ms_per_superstep=row["ms_per_launch"], exchange_ms=ex_ms,
             cost_redundant_flops_frac=row["cost_redundant_flops_frac"],
             bound_ms_per_superstep=b_ms, bound_by=by, bound_bytes=b_bytes,
             bound_passes=_BOUND_PASSES["faces" if route.startswith("faces") else "exchange"],
             bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
             kernel_launches=row["kernel_launches"], seconds_all=row["seconds_all"])
        _BENCH_ROWS.append(dict(row))
        del row
        torch.cuda.empty_cache()

    for mesh, knobs, tb, no_direct in _FUSED_FULL_WIDTH:
        cfg = SolverConfig(grid=GridConfig.cube(n), mesh=MeshConfig(shape=mesh),
                           time_blocking=tb, **knobs)
        with _no_direct(no_direct):
            row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3,
                                   device="cuda:0")
        route = row["superstep_route"] if tb > 1 else row["step_route"]
        b_ms, by, b_bytes = sharded_superstep_bound(
            route, n, mesh, tb, 4, flops_per_update(_taps("7pt")), bw)
        _check(route in ("fused-dma", "fused-dma2", "fused-dma-3d", "fused-rdma",
                         "fused-rdma2", "overlap"), f"not an overlap route: {row}")
        ex_ms = _exchange_ms(cfg, route) if route == "overlap" else None
        passes = ("fused" if route.startswith("fused") and route != "fused-dma-3d"
                  else "faces" if route == "fused-dma-3d" else "exchange")
        _say("full_width", grid=row["grid"], stencil="7pt", dtype="float32",
             mesh=row["mesh"], halo=row["halo"], overlap=row["overlap"],
             fused_rdma=row["fused_rdma"], halo_plan=row["halo_plan"],
             messages_per_exchange=row["messages_per_exchange"], no_direct=no_direct,
             shards_per_device=row["shards_per_device"], time_blocking=tb, route=route,
             steps=row["steps"], gcell_updates_per_sec=row["gcell_updates_per_sec"],
             ms_per_superstep=row["ms_per_launch"], exchange_ms=ex_ms,
             bound_ms_per_superstep=b_ms, bound_by=by, bound_bytes=b_bytes,
             bound_passes=_BOUND_PASSES[passes],
             bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
             kernel_launches=row["kernel_launches"], seconds_all=row["seconds_all"])
        _BENCH_ROWS.append(dict(row))
        del row
        torch.cuda.empty_cache()

    for mesh, halo, tb, knobs in (((1, 1, 1), "ppermute", 2, {}),
                                  ((1, 1, 1), "ppermute", 4, {}),
                                  (_MESH, "dma", 4, {}),
                                  ((8, 1, 1), "dma", 2, {"overlap": True})):
        cfg = SolverConfig(
            grid=GridConfig.cube(n),
            stencil=StencilConfig(kind="7pt", bc=_bc(True)),
            mesh=MeshConfig(shape=mesh), halo=halo, time_blocking=tb, **knobs,
        )
        solver = HeatSolver3D(cfg, device=None if mesh == (1, 1, 1) else "cuda:0")
        u = solver.init_state("hot-cube")
        s0 = _field_sum(u)
        u = solver.run(u, 11)
        s1 = _field_sum(u)
        finite = all(bool(torch.isfinite(t).all()) for t in _shard_list(u))
        rel = abs(s1 - s0) / s0
        _check(finite and rel < 1e-5,
               f"periodic tb={tb} mesh {mesh} {halo} sum drifted: {s0} -> {s1} ({rel})")
        _say("conservation", grid=[n, n, n], mesh=list(mesh), halo=halo, **knobs,
             time_blocking=tb, steps=11, sum_before=s0, sum_after=s1, rel_drift=rel,
             finite=finite)
        del u, solver
        torch.cuda.empty_cache()


def _shard_list(u):
    return [u] if hasattr(u, "double") else list(u.shards)


def _field_sum(u) -> float:
    """fp64 sum of a field (a tensor, or a ShardedField's shards in order)."""
    return float(sum(t.double().sum() for t in _shard_list(u)))


def _exchange_ms(cfg, route: str) -> float:
    """One exchange of ``route`` (faces-only for the faces-direct routes,
    else the padded-block plan of the route's width on ``cfg.halo``) on
    shards of random data in the storage dtype, timed alone on cuda:0."""
    return _exchange_times(cfg, route)["exchange_ms"]


def _exchange_times(cfg, route: str, split: bool = False) -> dict:
    """``exchange_ms`` of :func:`_exchange_ms`; with ``split`` (a sharded
    padded-block plan) also its two parts timed alone: ``interior_copy_ms``
    (every shard's field into its block, ``ExchangePlan.copy_interior``)
    and ``pushes_ms`` (every ghost slab, ``ExchangePlan.push_faces``), and
    ``pushes_enqueue_ms``, the host's time to issue the pushes (no sync;
    the least of 5): where it is near ``pushes_ms``, the host bounds the
    pushes alone."""
    import torch

    from heat3d_tpu_torch.parallel.step import make_exchanges
    from heat3d_tpu_torch.parallel.topology import build_shard_mesh

    mesh = build_shard_mesh(cfg, "cuda:0")
    dtype = getattr(torch, cfg.precision.storage)
    us = [torch.rand(mesh.local_shape, device=s.device).to(dtype) for s in mesh.shards]
    ex = make_exchanges(cfg, mesh)
    width = cfg.time_blocking if route in ("faces-direct2", "streamk") else 1
    plan = (ex.faces(width, dtype) if route.startswith("faces")
            else ex.plan(width, dtype))
    bcv = cfg.stencil.bc_value

    def timed(fn):
        def go():
            mesh.fork()
            fn(us, bcv)
            mesh.join()

        return _time_ms(go, iters=5)

    times = {"exchange_ms": timed(plan.apply)}
    if split:
        times["interior_copy_ms"] = timed(plan.copy_interior)
        times["pushes_ms"] = timed(plan.push_faces)
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan.push_faces(us, bcv)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times["pushes_enqueue_ms"] = min(enqueue)
    del us, plan, ex
    torch.cuda.empty_cache()
    return times


def _time_ms(fn, iters: int = 5) -> float:
    from heat3d_tpu_torch.utils.timing import time_fn

    return min(time_fn(fn, warmup=1, iters=iters)) * 1e3


def _library_check(name: str, got, lib_out, taps, u) -> dict:
    """Hold the library call to a kernel: both sides sum at most 27 fp32
    products in their own order, each within 28 * 2^-24 * sum|w| * max|u|
    of the exact sum."""
    import numpy as np

    err = float((lib_out - got).abs().max())
    tol = 2 * 28 * 2.0**-24 * float(np.abs(taps).sum()) * float(u.abs().max())
    _check(err <= tol, f"library call disagrees with {name}: {err} > {tol}")
    return {f"library_vs_{name}_max_abs_err": err, f"library_vs_{name}_tol": tol}


def phase_kernel_times(bw: float, worst: dict, resources: dict) -> dict:
    """Kernel and plain-version times at 256^3 and 1024^3 fp32 7pt, with
    each kernel held bitwise to its plain version at those sizes (7pt fp32
    with bc 0, 0.3 and periodic, 27pt fp32 and 7pt bf16: the settings the
    full-width phase gives the kernels), folding the errors into
    ``worst``; the halo exchange's time at each width (the solver's
    (1,1,1) plan); and the library call (one cuDNN convolution, TF32 off,
    never called by the port) over the same input as the tb=1 kernel and
    the stream kernel, held to both within a rounding bound. Returns the
    1024^3 numbers of each kernel (streamk at its headline depth)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    times = {}
    for n in (256, 1024):
        taps = _taps("7pt", n)
        flops = flops_per_update(taps)
        u = torch.rand((n, n, n), device="cuda")
        out = torch.empty_like(u)
        times[n] = {}
        exchange_ms = {}
        cases = 0
        for name, k in _cases():
            key = name if name != "apply_taps_streamk" else f"{name}_k{k}"
            kern, plain = _kernel_pair(name, k)
            x = u
            if name not in ("apply_taps_direct", "apply_taps_direct2"):
                plan = _one_shard_plan(u, False, k)
                x = plan.apply([u], 0.0)[0]
                exchange_ms[k] = _time_ms(lambda: plan.apply([u], 0.0), iters=5)
                del plan
            ms = _time_ms(lambda: kern(x, taps, False, 0.0, out=out), iters=10)
            plain_ms = _time_ms(lambda: plain(x, taps, False, 0.0), iters=3)
            # ``out`` holds the last timed launch's result
            _hold(worst, name, out, plain(x, taps, False, 0.0),
                  f"k={k} at {n}^3 7pt float32 bc=0.0")
            if name == "apply_taps_direct":
                direct_out = out.clone()
            elif name == "apply_taps_stream":
                up1, stream_out = x, out.clone()
            gen = (_stream_generic_ms(worst, name, k, x, taps, out, bw)
                   if name.startswith("apply_taps_stream") else {})
            del x
            for kind, dtype, periodic, bcv in (
                ("7pt", torch.float32, False, 0.3), ("7pt", torch.float32, True, 0.0),
                ("27pt", torch.float32, False, 0.0), ("7pt", torch.bfloat16, False, 0.0),
            ):
                v = u.to(dtype)
                got, want = _run_kernel(name, v, _taps(kind, n), periodic, bcv, k)
                _hold(worst, name, got, want,
                      f"k={k} at {n}^3 {kind} {dtype} periodic={periodic} bc={bcv}")
                del v, got, want
                torch.cuda.empty_cache()
            cases += 5
            b_ms, by = kernel_bound(name, n, k, 4, flops, bw)
            times[n][key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": by, "library_ms": None}
            if name.startswith("apply_taps_stream"):
                times[n][key]["blocks_per_sm"] = resources[f"k{k}_7pt_float32"]["blocks_per_sm"]
                times[n][key].update(gen)
                times[n][key]["generic_resources"] = resources[f"k{k}_generic_float32"]
            else:
                times[n][key].update(_direct_generic_ms(worst, name, k, u, taps, out, bw))
                times[n][key].update(resources[f"h{k}_7pt_float32"])
                times[n][key]["generic_resources"] = resources[f"h{k}_generic_float32"]
        extra = {}
        if n == 1024:
            # yardstick, never called by the port: one cuDNN convolution
            # (TF32 off) over the Dirichlet-padded field computes the tb=1
            # update of both the direct and the stream kernel
            torch.backends.cudnn.allow_tf32 = False
            w = torch.from_numpy(np.asarray(taps, dtype=np.float32)).cuda()[None, None]

            def library():
                return F.conv3d(up1[None, None], w)

            lib_ms = _time_ms(library, iters=3)
            lib = library()[0, 0]
            for name, got in (("apply_taps_direct", direct_out),
                              ("apply_taps_stream", stream_out)):
                times[n][name]["library_ms"] = lib_ms
                extra.update(_library_check(name, got, lib, taps, u))
            del lib
        del up1, direct_out, stream_out
        del u, out
        torch.cuda.empty_cache()
        _say("kernel_times", grid=[n, n, n], stencil="7pt", dtype="float32",
             times=times[n], exchange_ms_by_width=exchange_ms, bitwise_cases=cases,
             max_abs_err=worst, **extra)
    t = times[1024]
    _say("direct_times", grid=[1024] * 3,
         variants=_direct_variant_times(bw, worst, resources),
         generic_over_compiled={name: t[name]["generic_ms"] / t[name]["ms"]
                                for name in ("apply_taps_direct", "apply_taps_direct2")},
         generic_advection_over_compiled={
             name: t[name]["generic_advection_ms"] / t[name]["ms"]
             for name in ("apply_taps_direct", "apply_taps_direct2")},
         max_abs_err={n: worst[n] for n in ("apply_taps_direct", "apply_taps_direct2")})
    variants = _stream_variant_times(bw, worst, resources)
    d1, d2 = t["apply_taps_direct"]["ms"], t["apply_taps_direct2"]["ms"]
    ratios = {
        "stream1_over_direct1": t["apply_taps_stream"]["ms"] / d1,
        "streamk_k2_over_direct2": t["apply_taps_streamk_k2"]["ms"] / d2,
        "streamk_k4_over_direct2": t["apply_taps_streamk_k4"]["ms"] / d2,
    }
    streams = [name if k == 1 else f"{name}_k{k}" for name, k in _cases()[2:]]
    _say("stream_times", grid=[1024] * 3, variants=variants, ratios_7pt_float32=ratios,
         direct_ms={"apply_taps_direct": d1, "apply_taps_direct2": d2},
         generic={key: {f: t[key][f] for f in ("generic_ms", "generic_bound_ms",
                                                "generic_advection_ms", "generic_resources")}
                  for key in streams},
         generic_over_compiled={key: t[key]["generic_ms"] / t[key]["ms"] for key in streams},
         generic_advection_over_compiled={key: t[key]["generic_advection_ms"] / t[key]["ms"]
                                          for key in streams},
         max_abs_err={n: worst[n] for n in ("apply_taps_stream", "apply_taps_streamk")})
    t["apply_taps_streamk"] = t[f"apply_taps_streamk_k{_STREAMK_HEADLINE}"]
    return t


def _advection_taps(n: int):
    """The registry's advection-diffusion taps at vx=2 on an n^3 grid (7pt):
    a program of six terms, no ``CHAINS`` entry."""
    from heat3d_tpu_torch import eqn

    return eqn.solver_taps(_family_cfg(n, "advection-diffusion", (("vx", 2.0),), "7pt", 1))


def _direct_generic_ms(worst: dict, name: str, halo: int, u, taps, out, bw: float) -> dict:
    """The generic direct instance forced on ``taps``' chain and on the
    advection-diffusion vx=2 program (``_advection_taps``, which the solver
    runs on it) over ``u``: ms per launch beside its bound, the last launch
    of each held bitwise to the plain version. ``out`` is overwritten."""
    from heat3d_tpu_torch.ops import stencil_direct as sd

    n = u.shape[0]
    _, plain = _kernel_pair(name, halo)
    res = {}
    for key, t in (("generic", taps), ("generic_advection", _advection_taps(n))):
        ms = _time_ms(lambda: sd.launch_instance(halo, 0, u, t, out=out), iters=10)
        _hold(worst, name, out, plain(u, t, False, 0.0),
              f"{key} instance at {tuple(u.shape)} {u.dtype}")
        b_ms, _ = kernel_bound(name, n, halo, u.element_size(), flops_per_update(t), bw)
        res.update({f"{key}_ms": ms, f"{key}_bound_ms": b_ms})
    return res


def _stream_generic_ms(worst: dict, name: str, k: int, x, taps, out, bw: float) -> dict:
    """The generic stream instance forced (``ss.launch_instance(k, 0,
    ...)``) on ``taps``' chain and on the advection-diffusion vx=2 program
    (``_advection_taps``, which the solver runs on it) over the padded
    block ``x``: ms per launch beside its bound, the last launch of each
    held bitwise to the plain version. ``out`` is overwritten."""
    from heat3d_tpu_torch.ops import stencil_stream as ss

    n = out.shape[0]
    _, plain = _kernel_pair(name, k)
    res = {}
    for key, t in (("generic", taps), ("generic_advection", _advection_taps(n))):
        ms = _time_ms(lambda: ss.launch_instance(k, ss.GENERIC, x, t, out=out), iters=10)
        _hold(worst, name, out, plain(x, t, False, 0.0),
              f"{key} instance k={k} at {tuple(out.shape)} {x.dtype}")
        b_ms, _ = kernel_bound(name, n, k, x.element_size(), flops_per_update(t), bw)
        res.update({f"{key}_ms": ms, f"{key}_bound_ms": b_ms})
    return res


def _direct_variant_times(bw: float, worst: dict, resources: dict) -> dict:
    """direct1 and direct2 at 1024^3, Dirichlet bc 0, in the 27pt fp32 and
    7pt bf16 instances (the 7pt fp32 ones are ``kernel_times``'): ms per
    launch, bound, registers, spills, blocks per SM and shared memory, each
    launch held bitwise to its plain version."""
    import torch

    from heat3d_tpu_torch.ops import stencil_stream as ss

    n = 1024
    out_times = {}
    for kind, dtype in (("27pt", torch.float32), ("7pt", torch.bfloat16)):
        taps = _taps(kind, n)
        u = torch.rand((n, n, n), device="cuda").to(dtype)
        out = torch.empty_like(u)
        for name, halo in _cases()[:2]:
            kern, plain = _kernel_pair(name, halo)
            ms = _time_ms(lambda: kern(u, taps, False, 0.0, out=out), iters=10)
            _hold(worst, name, out, plain(u, taps, False, 0.0),
                  f"at {n}^3 {kind} {dtype} bc=0.0")
            b_ms, by = kernel_bound(name, n, halo, u.element_size(), flops_per_update(taps), bw)
            code = ss.stream_instance(taps)
            out_times[f"h{halo}_{kind}_{str(dtype)[6:]}"] = {
                "ms": ms, "bound_ms": b_ms, "bound_by": by, "instance": _instance_name(code),
                **resources[f"h{halo}_{_instance_name(code)}_{str(dtype)[6:]}"]}
        del u, out
        torch.cuda.empty_cache()
    return out_times


def _stream_variant_times(bw: float, worst: dict, resources: dict) -> dict:
    """The stream kernel and streamk K=4 at 1024^3, Dirichlet bc 0, in the
    27pt fp32 and 7pt bf16 instances (the 7pt fp32 ones are
    ``kernel_times``'): ms per launch, bound, blocks per SM and shared
    memory, each launch held bitwise to its plain version."""
    import torch

    from heat3d_tpu_torch.ops import stencil_stream as ss

    n = 1024
    out_times = {}
    for kind, dtype in (("27pt", torch.float32), ("7pt", torch.bfloat16)):
        taps = _taps(kind, n)
        u = torch.rand((n, n, n), device="cuda").to(dtype)
        for name, k in (("apply_taps_stream", 1), ("apply_taps_streamk", _STREAMK_HEADLINE)):
            kern, plain = _kernel_pair(name, k)
            x = _padded(u, False, 0.0, k)
            out = torch.empty_like(u)
            ms = _time_ms(lambda: kern(x, taps, False, 0.0, out=out), iters=10)
            _hold(worst, name, out, plain(x, taps, False, 0.0),
                  f"k={k} at {n}^3 {kind} {dtype} bc=0.0")
            b_ms, by = kernel_bound(name, n, k, u.element_size(), flops_per_update(taps), bw)
            code = ss.stream_instance(taps)
            out_times[f"k{k}_{kind}_{str(dtype)[6:]}"] = {
                "ms": ms, "bound_ms": b_ms, "bound_by": by,
                "instance": _instance_name(code),
                **resources[f"k{k}_{_instance_name(code)}_{str(dtype)[6:]}"]}
            del x, out
            torch.cuda.empty_cache()
        del u
        torch.cuda.empty_cache()
    return out_times


def _dma_axis_bytes(mesh, axis: int, width: int, itemsize: int, periodic: bool) -> int:
    """Bytes one axis of the DMA exchange must move: each pushed face slab
    read once and written once into the neighbour, each domain-face ghost
    slab written once."""
    local = mesh.local_shape
    slab = 1
    for a, m in enumerate(local):
        slab *= width if a == axis else (m + 2 * width if a < axis else m)
    total = 0
    for s in mesh.shards:
        for d in (-1, +1):
            total += slab * (1 if mesh.neighbor(s, axis, d, periodic) is None else 2)
    return total * itemsize


def _unit_cells(name: str) -> int:
    """Output cells of the launch the kernels line times: a 1024^3 field for
    the stencil and fused kernels; for the DMA pairs the ghost cells of one
    whole width-1 exchange over the (2,2,2) mesh of 512^3 shards (two slabs
    a shard and axis, as ``halo_dma.cell_counts`` counts them)."""
    if name != "halo_dma":
        return 1024**3
    m, w = 512, 1
    padded = m + 2 * w
    per_shard = 2 * (w * m * m + padded * w * m + padded * padded * w)
    return 8 * per_shard


def _dma_sector_bytes(mesh, axis: int, width: int, itemsize: int, periodic: bool) -> int:
    """The least bytes one axis of the DMA exchange moves in 32-byte sectors:
    each slab row (contiguous along z) touches at least ceil(row bytes / 32)
    sectors, once read and once written where pushed, once written where
    filled. x and y rows are whole z rows, so this is their byte count; a
    z slab's rows are ``width`` elements, a sector each."""
    local = mesh.local_shape
    ext = [width if a == axis else (m + 2 * width if a < axis else m)
           for a, m in enumerate(local)]
    per_side = ext[0] * ext[1] * -(-ext[2] * itemsize // 32) * 32
    total = 0
    for s in mesh.shards:
        for d in (-1, +1):
            total += per_side * (1 if mesh.neighbor(s, axis, d, periodic) is None else 2)
    return total


def _per_call_ms(fn, calls: int = 20, samples: int = 5) -> float:
    """Device ms per call of ``fn(calls)`` (which makes ``calls`` calls in a
    row), the least of ``samples``, after one warm-up call."""
    import torch

    fn(1)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(calls)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def phase_dma_times(bw: float, worst: dict) -> dict:
    """The DMA exchange of each axis on a (2,2,2) mesh of 512^3 fp32 shards
    on cuda:0 (Dirichlet bc 0, the full-width phase's setting), at widths 1
    and 4, against the plain version's slab copies (which are
    ``Tensor.copy_`` calls, the library yardstick too). ``ms``: the least of
    10 single calls, each between its own events (the kernels' with its own
    fork and join of the shard streams), as earlier PRs timed it;
    ``ms_in_a_row``: the mean of 20 calls in a row (the kernels' between one
    fork and one join), the least of 5 samples; the same two for the copies.
    Beside them the byte bound, the sector floor (``_dma_sector_bytes``) and
    the kernel launches a call makes; each held bitwise to the plain version
    there. Returns the kernels-line entry: one whole width-1 exchange's DMA
    launches (all three axes, single calls), the tb=1 main path's."""
    import torch

    from heat3d_tpu_torch.ops import halo_dma

    mesh = _card_mesh(_MESH, (512, 512, 512))
    times = {}
    for width in (1, 4):
        pads = [torch.rand(tuple(m + 2 * width for m in mesh.local_shape),
                           device=s.device) for s in mesh.shards]
        state = halo_dma.DmaState(mesh, pads, width, False)
        for axis in range(3):
            def kern(calls=1):
                mesh.fork()
                for _ in range(calls):
                    state.epoch += 1
                    halo_dma.exchange_axis_dma(pads, mesh, axis, width, False, 0.0, state)
                mesh.join()

            def plain(calls=1):
                for _ in range(calls):
                    halo_dma.exchange_axis_dma_ref(pads, mesh, axis, width, False, 0.0)

            before = halo_dma.launch_counts()["halo_dma"]
            kern()
            launches = halo_dma.launch_counts()["halo_dma"] - before
            ms = _time_ms(kern, iters=10)
            plain_ms = _time_ms(plain, iters=10)
            moved = _dma_axis_bytes(mesh, axis, width, 4, False)
            sectors = _dma_sector_bytes(mesh, axis, width, 4, False)
            b_ms, by = bound_ms(moved, 0, bw)
            times[f"w{width}_axis{axis}"] = {
                "ms": ms, "plain_ms": plain_ms, "ms_in_a_row": _per_call_ms(kern),
                "plain_ms_in_a_row": _per_call_ms(plain), "bound_ms": b_ms,
                "bound_by": by, "bytes": moved, "sector_bytes": sectors,
                "sector_floor_ms": sectors / bw * 1e3, "launches_per_call": launches,
                "library_ms": plain_ms}
            want = [p.clone() for p in pads]
            kern()
            halo_dma.exchange_axis_dma_ref(want, mesh, axis, width, False, 0.0)
            _hold_blocks(worst, pads, want, f"axis {axis} width {width} on 512^3 shards")
            _check(launches <= 2, f"DMA axis {axis} width {width}: {launches} launches a call")
            del want
        del pads, state
        torch.cuda.empty_cache()
    _say("dma_times", mesh=list(_MESH), shard=[512, 512, 512], dtype="float32",
         times=times, max_abs_err=worst["halo_dma"])
    w1 = [times[f"w1_axis{a}"] for a in range(3)]
    total = {key: sum(t[key] for t in w1) for key in ("ms", "plain_ms", "bound_ms")}
    return {**total, "bound_by": "bytes", "library_ms": total["plain_ms"]}


# (mesh, halo, halo_order, halo_plan, storage) of the halo_bench phase's
# timed rows at 1024^3 7pt bc 0, every shard on cuda:0
_HALO_ROWS = (
    ((1, 1, 1), "ppermute", "axis", "monolithic", "float32"),
    ((2, 2, 2), "ppermute", "axis", "monolithic", "float32"),
    ((2, 2, 2), "ppermute", "axis", "partitioned", "float32"),
    ((2, 2, 2), "ppermute", "pairwise", "monolithic", "float32"),
    ((2, 2, 2), "dma", "axis", "monolithic", "float32"),
    ((8, 1, 1), "ppermute", "axis", "monolithic", "float32"),
    ((8, 1, 1), "dma", "axis", "monolithic", "float32"),
    ((2, 2, 2), "dma", "axis", "monolithic", "bfloat16"),
)


def _halo_loop_pair(worst: dict, k: int, storage: str) -> int:
    """``bench_halo``'s loop, k exchanges with no host sync between them, on
    the DMA transport against the same loop on the plain version's slab
    copies (the ppermute transport), bitwise: (2,2,2) on cuda:0 at 128^3,
    Dirichlet bc 0.3, from the same random field."""
    import torch

    from heat3d_tpu_torch.bench.harness import halo_loop
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.ops import halo_dma
    from heat3d_tpu_torch.parallel.step import make_exchanges
    from heat3d_tpu_torch.parallel.topology import build_shard_mesh

    gen = torch.Generator(device="cuda").manual_seed(k)
    dtype = getattr(torch, storage)
    base = None
    out = {}
    for halo in ("dma", "ppermute"):
        cfg = SolverConfig(grid=GridConfig.cube(128), mesh=MeshConfig(shape=_MESH), halo=halo,
                           stencil=StencilConfig(bc_value=0.3),
                           precision=Precision(storage=storage))
        mesh = build_shard_mesh(cfg, "cuda:0")
        if base is None:
            base = [torch.rand(mesh.local_shape, device="cuda", generator=gen).to(dtype)
                    for _ in mesh.shards]
        plan = make_exchanges(cfg, mesh).plan(1, dtype)
        out[halo] = halo_loop(plan, mesh, [b.clone() for b in base], k, 0.3)
        torch.cuda.synchronize()
        halo_dma.raise_if_timed_out()
    for got, want in zip(out["dma"], out["ppermute"]):
        _hold(worst, "halo_dma", got, want, f"halo loop k={k} {storage} on {_MESH} at 128^3")
    _check(plan.dma is None, "the plain loop ran DMA kernels")
    return k


def _pairwise_on_card(worst: dict) -> int:
    """The pairwise exchange on (2,2,2) at 128^3 against the axis-ordered
    one: equal on every face-ghost cell (one axis in its ghost range), the
    cells in two or more ghost ranges at bc (rounded to the storage dtype),
    Dirichlet 0.3 and periodic, fp32 and bf16. Returns the cases held."""
    import torch

    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    local = tuple(128 // p for p in _MESH)
    mesh = _card_mesh(_MESH, local)
    ghost = [torch.zeros(n + 2, dtype=torch.bool, device="cuda") for n in local]
    for g in ghost:
        g[0] = g[-1] = True
    depth = (ghost[0][:, None, None].int() + ghost[1][None, :, None].int()
             + ghost[2][None, None, :].int())
    cases = 0
    for storage in ("float32", "bfloat16"):
        dtype = getattr(torch, storage)
        us = [torch.rand(local, device="cuda").to(dtype) for _ in mesh.shards]
        for periodic, bcv in ((False, 0.3), (True, 0.0)):
            pw = ExchangePlan(mesh, _bc(periodic), 1, "ppermute", dtype, halo_order="pairwise")
            ax = ExchangePlan(mesh, _bc(periodic), 1, "ppermute", dtype)
            mesh.fork()
            got, want = pw.apply(us, bcv), ax.apply(us, bcv)
            mesh.join()
            torch.cuda.synchronize()
            corner = torch.tensor(bcv, dtype=dtype, device="cuda")
            for a, b in zip(got, want):
                _check(torch.equal(a[depth <= 1], b[depth <= 1]),
                       f"pairwise != axis order on the face ghosts, {storage} "
                       f"periodic={periodic}")
                _check(bool((a[depth >= 2] == corner).all()),
                       f"pairwise edge zones not at bc {bcv}, {storage} periodic={periodic}")
            cases += 1
    return cases


def phase_halo_bench(bw: float, worst: dict) -> None:
    """The judged halo-exchange p50 (``bench_halo``), first held: the DMA
    halo loop bitwise to its plain loop at k = 7 and 4096 (fp32, bf16), the
    pairwise exchange against the axis-ordered one, and a pairwise
    ``--golden-check`` run (128^3, (2,2,2) on cuda:0, 20 steps, the stream
    kernel). Then ``_HALO_ROWS`` at 1024^3 fp32 7pt bc 0 (one row in bf16
    storage), ``iters=10``, one line each: the row's p50 / p95 of program
    means / min, exchanges per program and plan messages, beside the same
    exchange timed alone (``_exchange_ms``; on a sharded mesh also its
    interior copy and its pushes alone, and the host's time to issue the
    pushes) and ``bound_us`` (:func:`halo_exchange_bytes` at the card's
    memory rate); last, the phase's DMA kernel launches."""
    import torch

    from heat3d_tpu_torch.bench.harness import bench_halo
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig,
    )
    from heat3d_tpu_torch.ops import halo_dma

    _say("halo_bench", card=nvidia_smi(), grid=[1024] * 3, stencil="7pt", bc_value=0.0)
    launches = halo_dma.launch_counts()["halo_dma"]
    held = {f"loop_k{k}_{storage}": _halo_loop_pair(worst, k, storage)
            for k in (7, 4096) for storage in ("float32", "bfloat16")}
    held["pairwise_vs_axis_cases"] = _pairwise_on_card(worst)
    _golden_cli(["--grid", "128", "--steps", "20", "--stencil", "7pt", "--time-blocking", "1",
                 "--mesh", *map(str, _MESH), "--halo-order", "pairwise", "--device", "cuda:0"],
                "apply_taps_stream", grid=128, stencil="7pt", mesh=list(_MESH),
                halo_order="pairwise", time_blocking=1)
    _say("halo_bench", held_bitwise=held, max_abs_err=worst["halo_dma"])
    n = 1024
    for mesh, halo, order, plan, storage in _HALO_ROWS:
        cfg = SolverConfig(grid=GridConfig.cube(n), mesh=MeshConfig(shape=mesh), halo=halo,
                           halo_order=order, halo_plan=plan,
                           precision=Precision(storage=storage))
        row = bench_halo(cfg, iters=10, device=None if mesh == (1, 1, 1) else "cuda:0")
        alone = _exchange_times(cfg, "exchange", split=mesh != (1, 1, 1))
        itemsize = torch.empty((), dtype=getattr(torch, storage)).element_size()
        moved = halo_exchange_bytes(mesh, cfg.local_shape, order, itemsize)
        b_us = moved / bw * 1e6
        _check(row["platform"] == "gpu" and row["p95_mean_us"] >= row["p50_us"]
               >= row["min_us"] > 0, f"halo row {row}")
        _check((row["exchange_kernel_launches"] > 0) == (halo == "dma"),
               f"DMA launches of a {halo} halo row: {row['exchange_kernel_launches']}")
        _say("halo_bench", mesh=list(mesh), halo=halo, halo_order=order, halo_plan=plan,
             dtype=storage, p50_us=row["p50_us"], p95_mean_us=row["p95_mean_us"],
             min_us=row["min_us"], exchanges_per_program=row["exchanges_per_program"],
             plan_messages_per_exchange=row["plan_messages_per_exchange"],
             plan_bytes_per_device=row["plan_bytes_per_device"],
             halo_bytes_per_device=row["halo_bytes_per_device"], **alone,
             bound_us=b_us, bound_bytes=moved, bound_by="bytes",
             p50_over_bound=row["p50_us"] / b_us,
             exchange_kernel_launches=row["exchange_kernel_launches"],
             sync_rtt_us=row["sync_rtt_us"], rtt_dominated=row["rtt_dominated"],
             device_name=row["device_name"], shards_per_device=row["shards_per_device"])
        _BENCH_ROWS.append(dict(row))
        del row
        torch.cuda.empty_cache()
    _say("halo_bench", halo_dma_launches=halo_dma.launch_counts()["halo_dma"] - launches)


def phase_shard_kernel_times(bw: float, worst: dict) -> None:
    """The stencil kernels the full-width phase's (2,2,2) rows launch, on
    their 512^3 shards (every shard on cuda:0), with those rows' settings
    (fp32 7pt, Dirichlet bc 0; streamk also periodic, as the conservation
    run): ``direct1``/``direct2`` (faces-direct tb 1/2) on an unpadded
    shard, ``stream1`` (dma tb=1) on a width-1 padded block and streamk K=4
    (dma tb=4) on width-4 padded blocks, both made by the sharded DMA
    exchange, under the domain-edge masks of the corner shards (0,0,0) and
    (1,1,1) (three domain faces, three faces inside the mesh), Dirichlet
    and periodic (which pins nothing); and ``stream1`` as the overlap split
    runs it, on the unpadded shard as its own padded input (512^3 ->
    510^3). Each launch is held bitwise to its plain version and timed
    beside its bound; ``eight_ms`` is eight launches, one superstep's
    kernel time on the card."""
    import torch

    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    m, k = 512, _STREAMK_HEADLINE
    mesh = _card_mesh(_MESH, (m, m, m))
    taps = _taps("7pt", 2 * m)
    flops = flops_per_update(taps)
    us = [torch.rand((m, m, m), device=s.device) for s in mesh.shards]
    lo, hi = mesh.shards[0], mesh.shards[-1]
    times = {}

    def held(key, name, kk, x, periodic, edges=(True,) * 6, n_out=m):
        kern, plain = _kernel_pair(name, kk, edges)
        want = plain(x, taps, periodic, 0.0)
        out = torch.empty_like(want)
        ms = _time_ms(lambda: kern(x, taps, periodic, 0.0, out=out), iters=10)
        plain_ms = _time_ms(lambda: plain(x, taps, periodic, 0.0), iters=3)
        _hold(worst, name, out, want, f"{key} on a {tuple(x.shape)} input, edges {edges}")
        b_ms, by = kernel_bound(name, n_out, kk, 4, flops, bw)
        times[key] = {"ms": ms, "eight_ms": 8 * ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": by, "out": list(out.shape),
                      "edges": list(edges) if name == "apply_taps_streamk" else None}

    held("apply_taps_direct", "apply_taps_direct", 1, us[0], False)
    held("apply_taps_direct2", "apply_taps_direct2", 2, us[0], False)
    # the overlap split's interior: the shard as its own padded input
    held("apply_taps_stream_overlap_interior", "apply_taps_stream", 1, us[0], False,
         n_out=m - 2)
    for width, periodic, cases in (
        (1, False, (("apply_taps_stream", "apply_taps_stream", lo),)),
        (k, False, ((f"apply_taps_streamk_k{k}_shard000", "apply_taps_streamk", lo),
                    (f"apply_taps_streamk_k{k}_shard111", "apply_taps_streamk", hi))),
        (k, True, ((f"apply_taps_streamk_k{k}_periodic", "apply_taps_streamk", lo),)),
    ):
        plan = ExchangePlan(mesh, _bc(periodic), width, "dma", torch.float32)
        mesh.fork()
        pads = plan.apply(us, 0.0)
        mesh.join()
        for key, name, s in cases:
            held(key, name, width, pads[s.rank], periodic, s.edges)
        del plan, pads
        torch.cuda.empty_cache()
    del us
    torch.cuda.empty_cache()
    _say("shard_kernel_times", mesh=list(_MESH), shard=[m, m, m], stencil="7pt",
         dtype="float32", bc_value=0.0, times=times, bitwise=True,
         max_abs_err={n: worst[n] for n in KERNELS if n != "halo_dma"})


def _fused_state(mesh, name, dtype, periodic, floor=None):
    """The state of fused kernel ``name`` over ``mesh``: whole-face sends
    for the DMA kernels; the RDMA ones take the x-face sub-blocks of a
    partitioned plan schedule at the granularity ``floor`` (default: the
    plan's own)."""
    import torch

    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
    from heat3d_tpu_torch.parallel.plan import DEFAULT_PART_MIN_BYTES, Schedule

    k = _FUSED[name][0]
    bounds = None
    if name.endswith("rdma"):
        sched = Schedule(mesh.shape, k, "partitioned",
                         min_part_bytes=DEFAULT_PART_MIN_BYTES if floor is None else floor)
        bounds = fr.plan_send_bounds(sched, mesh.local_shape,
                                     torch.empty((), dtype=dtype).element_size())
    return fd.FusedState(mesh, k, dtype, periodic, bounds)


def _fused_wrapper(name):
    """The wrapper function of fused kernel ``name`` (it holds the counts)."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr

    return getattr(fd, name, None) or getattr(fr, name)


def _fused_pair(name, cd=None):
    """(kernel wrapper, plain version) of fused kernel ``name``, both
    called ``f(us, taps, mesh, state, periodic, bc_value)``, in compute
    dtype ``cd`` (default float32; the kernel also takes ``outs=``)."""
    import torch

    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    cd = cd or torch.float32
    wrapper = _fused_wrapper(name)
    ref = getattr(fd, _FUSED[name][1])

    def kern(us, t, m, st, p, b, outs=None):
        return wrapper(us, t, m, st, p, b, outs=outs, compute_dtype=cd)

    return kern, (lambda us, t, m, st, p, b: ref(us, t, m, p, b, compute_dtype=cd))


def _fused_names(mesh_shape, nx):
    """The fused kernels a mesh takes: all four on an x-slab (tb=2 needs
    nx >= 4), the one-update DMA kernel on an x-sharded block mesh."""
    if mesh_shape[1] == mesh_shape[2] == 1:
        return [n for n in _FUSED if _FUSED[n][0] == 1 or nx >= 4]
    return ["apply_step_fused_dma"]


def _hold_fused(worst, name, got, want, what):
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    import torch

    torch.cuda.synchronize()
    fd.raise_if_timed_out()
    for g, w in zip(got, want):
        _hold(worst, name, g, w, what)


# the fused kernels' generic battery: (mesh, global field, send ranges a
# face): the x-slab of the main path cut to 64 x 40 x 70, (4,1,1) with
# three ranges, the 3D route's (2,2,2) (one update) and the ragged, odd
# ny*nz (8,77,125) over (2,1,1) (bf16 planes, the landed ones too, start
# on either parity)
_FUSED_GENERIC_MESHES = (((8, 1, 1), (64, 40, 70), 1), ((4, 1, 1), (16, 20, 70), 3),
                         ((2, 2, 2), (12, 20, 70), 1), ((2, 1, 1), (8, 77, 125), 3))
# the programs it forces on the generic instance (``_stream_generic_programs``)
_FUSED_GENERIC_PROGRAMS = ("advection", "asym27")


def _compare_fused_generic(worst: dict, cd) -> int:
    """The fused kernels (``_fused_names`` of each mesh) on the generic
    instance, forced (``fd.launch_instance(0, ...)``) on each program of
    ``_FUSED_GENERIC_PROGRAMS`` over ``_FUSED_GENERIC_MESHES`` (fp32/bf16
    storage) and over (8,1,1) on ``_special_field`` (fp32 storage), in
    compute dtype ``cd``, Dirichlet 0.3 and periodic: each launch bitwise
    against its plain version (NaN in the same cells) and counted on the
    generic instance. Returns the number of cases."""
    import numpy as np
    import torch

    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    progs = _stream_generic_programs()
    fields = [(mesh_shape, parts, np.random.default_rng(23).standard_normal(shape)
               .astype(np.float32), dtype)
              for mesh_shape, shape, parts in _FUSED_GENERIC_MESHES
              for dtype in (torch.float32, torch.bfloat16)]
    fields.append(((8, 1, 1), 1, _special_field((64, 40, 70), 15), torch.float32))
    n = 0
    for mesh_shape, parts, base, dtype in fields:
        local = tuple(g // p for g, p in zip(base.shape, mesh_shape))
        mesh = _card_mesh(mesh_shape, local)
        us = _split(torch.from_numpy(base).cuda().to(dtype), mesh)
        bounds = partition_bounds(local[1], parts) if parts > 1 else None
        for prog, (periodic, bcv) in itertools.product(_FUSED_GENERIC_PROGRAMS,
                                                       ((False, 0.3), (True, 0.0))):
            taps = progs[prog]
            for name in _fused_names(mesh_shape, local[0]):
                _, plain = _fused_pair(name, cd=cd)
                state = fd.FusedState(mesh, _FUSED[name][0], dtype, periodic, bounds)
                before = _generic_counts()[name]
                got = fd.launch_instance(0, us, taps, mesh, state, periodic, bcv,
                                         wrapper=_fused_wrapper(name), compute_dtype=cd)
                want = plain(us, taps, mesh, None, periodic, bcv)
                fd.raise_if_timed_out()
                for g, w in zip(got, want):
                    _hold_nan(worst, name, g, w,
                              f"generic {prog} on {mesh_shape} {tuple(base.shape)} {dtype} "
                              f"compute {cd} periodic={periodic} ranges {state.bounds}")
                _check(_generic_counts()[name] == before + 1,
                       f"{name} {prog}: not counted on the generic instance")
                n += 1
                del got, want, state
        del us
    torch.cuda.empty_cache()
    return n


def _fused_burst(worst, mesh, name, base_us, periodic, bcv, n=50):
    """``n`` launches of fused kernel ``name`` in a row on one state, each
    shard's new input made and its output copied out on the shard's own
    stream, with no host synchronisation between them; then each held to
    the plain version."""
    import torch

    taps = _taps("7pt")
    kern, plain = _fused_pair(name)
    state = _fused_state(mesh, name, base_us[0].dtype, periodic, floor=0)
    snaps = []
    mesh.fork()
    for i in range(n):
        us = []
        for s, b in zip(mesh.shards, base_us):
            with mesh.on(s):
                us.append(b + i)
        outs = kern(us, taps, mesh, state, periodic, bcv)
        snap = []
        for s, o in zip(mesh.shards, outs):
            with mesh.on(s):
                snap.append(o.clone())
        snaps.append(snap)
    mesh.join()
    for i, snap in enumerate(snaps):
        want = plain([b + i for b in base_us], taps, mesh, None, periodic, bcv)
        _hold_fused(worst, name, snap, want, f"launch {i + 1} of {n} on {mesh.shape}")
    del snaps
    torch.cuda.empty_cache()
    return n


# (mesh, knobs, HEAT3D_NO_DIRECT, stencil, storage, periodic) of the overlap
# routes' 128^3 solves against the (1,1,1) solve
_FUSED_SOLVES = (
    ((8, 1, 1), {"halo": "dma", "overlap": True}, 1, False, "7pt", "float32", False),
    ((8, 1, 1), {"halo": "dma", "overlap": True}, 2, False, "27pt", "bfloat16", True),
    ((4, 1, 1), {"halo": "dma", "overlap": True}, 2, False, "7pt", "float32", False),
    ((2, 2, 2), {"halo": "dma", "overlap": True}, 1, False, "27pt", "float32", False),
    ((2, 2, 2), {"halo": "dma", "overlap": True}, 1, False, "7pt", "float32", True),
    ((4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, 1, False, "7pt",
     "float32", False),
    ((4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, 2, False, "27pt",
     "float32", True),
    ((8, 1, 1), {"fused_rdma": "on"}, 2, False, "7pt", "bfloat16", False),
    ((2, 2, 2), {"overlap": True}, 1, True, "27pt", "float32", False),
    ((2, 2, 2), {"halo_plan": "partitioned"}, 2, False, "7pt", "float32", False),
)


def phase_compare_fused(worst: dict) -> None:
    """The fused kernels against their plain versions, bitwise, every shard
    on cuda:0 in one launch: 128^3 over (4,1,1), (8,1,1) and (2,2,2) (the
    landed ghosts too), 7pt/27pt x Dirichlet 0.3/periodic x fp32/bf16, the
    RDMA kernels at floor 0 and the default floor; the full-width shard
    shapes (1024^3 over (8,1,1), (4,1,1) and (2,2,2), the landed ghosts
    too); (8,77,125) over (2,1,1), a ragged, odd ny*nz (bf16 planes, landed
    ones too, start on either parity) with sends whole and in two and
    three ranges, the same settings; 50 launches in a row; the generic
    instance forced on the generic programs (``_compare_fused_generic``);
    the overlap routes' 128^3 solves against the (1,1,1) solve; and at
    1024^3 against the (1,1,1) solve: the (8,1,1)
    tb=2 run whose tb=1 state is built mid-run on busy streams, the (2,2,2)
    3D fused route and the (2,2,2) overlap split."""
    import numpy as np
    import torch

    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.parallel.plan import partition_bounds
    from heat3d_tpu_torch.parallel.step import step_route, superstep_route

    t0 = time.perf_counter()
    cases = ghosts = 0
    for n, mesh_shapes, settings in (
        (128, ((4, 1, 1), (8, 1, 1), (2, 2, 2)),
         [(k, d, p, b) for k in ("7pt", "27pt") for d in (torch.float32, torch.bfloat16)
          for p, b in ((False, 0.3), (True, 0.0))]),
        (1024, ((8, 1, 1), (4, 1, 1), (2, 2, 2)),
         [("7pt", torch.float32, False, 0.3), ("7pt", torch.float32, True, 0.0),
          ("27pt", torch.float32, False, 0.0), ("7pt", torch.bfloat16, False, 0.0)]),
    ):
        base = torch.from_numpy(
            np.random.default_rng(12).standard_normal((n, n, n)).astype(np.float32)).cuda()
        for mesh_shape in mesh_shapes:
            mesh = _card_mesh(mesh_shape, tuple(n // p for p in mesh_shape))
            for kind, dtype, periodic, bcv in settings:
                taps = _taps(kind)
                us = _split(base.to(dtype), mesh)
                what = f"{n}^3 on {mesh_shape} {kind} {dtype} periodic={periodic} bc={bcv}"
                for name in _fused_names(mesh_shape, mesh.local_shape[0]):
                    kern, plain = _fused_pair(name)
                    for floor in ((0, None) if name.endswith("rdma") else (None,)):
                        state = _fused_state(mesh, name, dtype, periodic, floor)
                        got = kern(us, taps, mesh, state, periodic, bcv)
                        _hold_fused(worst, name, got,
                                    plain(us, taps, mesh, None, periodic, bcv),
                                    f"{what} ranges {state.bounds}")
                        cases += 1
                        del got, state
                state = fd.FusedState(mesh, 1, dtype, periodic)
                _, got = fd.apply_step_fused_dma(us, taps, mesh, state, periodic, bcv,
                                                 return_ghosts=True)
                _, want = fd.reference_fused_step(us, taps, mesh, periodic, bcv,
                                                  return_ghosts=True)
                for g, w in zip(got, want):
                    _hold_fused(worst, "apply_step_fused_dma", g, w, f"ghosts {what}")
                ghosts += 1
                del us, got, want, state
                torch.cuda.empty_cache()
        del base
        torch.cuda.empty_cache()

    mesh = _card_mesh((2, 1, 1), (4, 77, 125))
    base = torch.from_numpy(
        np.random.default_rng(16).standard_normal((8, 77, 125)).astype(np.float32)).cuda()
    for kind, dtype, (periodic, bcv) in itertools.product(
            ("7pt", "27pt"), (torch.float32, torch.bfloat16), ((False, 0.3), (True, 0.0))):
        taps = _taps(kind)
        us = _split(base.to(dtype), mesh)
        for name, parts in itertools.product(_FUSED, (1, 2, 3)):
            kern, plain = _fused_pair(name)
            state = fd.FusedState(mesh, _FUSED[name][0], dtype, periodic,
                                  partition_bounds(77, parts))
            got = kern(us, taps, mesh, state, periodic, bcv)
            _hold_fused(worst, name, got, plain(us, taps, mesh, None, periodic, bcv),
                        f"(8,77,125) on (2,1,1) {kind} {dtype} periodic={periodic} bc={bcv} "
                        f"ranges {state.bounds}")
            cases += 1
    del base, us

    mesh = _card_mesh((8, 1, 1), (16, 128, 128))
    base_us = _split(torch.from_numpy(
        np.random.default_rng(13).standard_normal((128, 128, 128)).astype(np.float32)).cuda(),
        mesh)
    bursts = (_fused_burst(worst, mesh, "apply_step_fused_dma", base_us, False, 0.3)
              + _fused_burst(worst, mesh, "apply_superstep_fused_rdma", base_us, True, 0.0))
    del base_us
    generic = _compare_fused_generic(worst, torch.float32)

    # 1024^3, 11 steps, against the (1,1,1) solve: (8,1,1) tb=2 builds the
    # tb=1 state of the remainder step while the supersteps still run on the
    # eight shard streams; (2,2,2) runs the 3D fused route and the overlap
    # split on 512^3 shards, the full-width rows' shapes
    def solve(mesh, **knobs):
        cfg = SolverConfig(grid=GridConfig.cube(1024),
                           stencil=StencilConfig(kind="7pt", bc_value=0.3),
                           mesh=MeshConfig(shape=mesh), **knobs)
        solver = HeatSolver3D(cfg, device="cuda:0")
        return solver, solver.run(solver.init_state("hot-cube"), 11)

    _, want = solve((1, 1, 1))
    full_solves = []
    for mesh_shape, knobs, no_direct, route in (
        ((8, 1, 1), dict(halo="dma", overlap=True, time_blocking=2), False, "fused-dma2"),
        ((2, 2, 2), dict(halo="dma", overlap=True), False, "fused-dma-3d"),
        ((2, 2, 2), dict(overlap=True), True, "overlap"),
    ):
        with _no_direct(no_direct):
            solver, got = solve(mesh_shape, **knobs)
            took = (superstep_route(solver.cfg) if solver.cfg.time_blocking > 1
                    else step_route(solver.cfg))
        torch.cuda.synchronize()
        fd.raise_if_timed_out()
        _check(took == route, f"{mesh_shape} {knobs} took {took}, not {route}")
        for s, shard in zip(solver.mesh.shards, got.shards):
            region = tuple(slice(o, o + m) for o, m in zip(s.origin, solver.mesh.local_shape))
            _check(torch.equal(shard, want[region]),
                   f"1024^3 {route} on {mesh_shape} != (1,1,1) at shard {s.coords}")
        full_solves.append([list(mesh_shape), route])
        del got, solver
        torch.cuda.empty_cache()
    del want
    torch.cuda.empty_cache()

    solves = []
    for mesh_shape, knobs, tb, no_direct, kind, storage, periodic in _FUSED_SOLVES:
        bcv = 0.0 if periodic else 0.3
        want = _solve_gathered(128, (1, 1, 1), kind, storage, periodic, bcv, 1, 21)
        with _env(HEAT3D_PLAN_PART_MIN_BYTES="0"):
            got = _solve_gathered(128, mesh_shape, kind, storage, periodic, bcv, tb, 21,
                                  no_direct=no_direct, device="cuda:0", **knobs)
        _check(got.tobytes() == want.tobytes(),
               f"overlap-route solve != (1,1,1) solve: {mesh_shape} {knobs} tb={tb} "
               f"{kind} {storage} periodic={periodic}: max err "
               f"{float(np.abs(got - want).max())}")
        solves.append([list(mesh_shape), knobs, tb, no_direct, kind, storage, periodic])
    _say("compare_fused", cases=cases, ghost_cases=ghosts, generic_cases=generic,
         launches_in_a_row=bursts,
         mid_run_state=True, overlap_vs_single_solves=solves,
         full_width_vs_single_solves=full_solves, bitwise=True,
         max_abs_err={k: worst[k] for k in _FUSED}, launches=ops.launch_counts(),
         seconds=time.perf_counter() - t0)


def _bf16_counts() -> dict:
    """Launches in bf16 compute, per stencil kernel wrapper and of the
    Mehrstellen instances (keyed as ``_MEHR``)."""
    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.ops import stencil_direct as sd

    return {**ops.compute_bf16_launch_counts(),
            **{f"{name}:mehrstellen": n
               for name, n in sd.compute_bf16_mehrstellen_launch_counts().items()}}


def _hold_bf16(worst, name, run, want, what, counted=None) -> None:
    """``run()`` (one launch of ``name``'s wrapper in bf16 compute) bitwise
    against ``want`` (a tensor, or the shards' list), counted once as a
    bf16-compute launch of ``counted`` (default ``name``)."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    counted = counted or name
    before = _bf16_counts()[counted]
    got = run()
    if isinstance(got, list):
        _hold_fused(worst, name, got, want, what)
    else:
        _hold(worst, name, got, want, what)
    fd.raise_if_timed_out()
    _check(_bf16_counts()[counted] == before + 1,
           f"{counted} {what}: not one bf16-compute launch")


def phase_compare_bf16(worst: dict) -> None:
    """bf16 compute: every bf16-compute instance bitwise against its plain
    version on the card (the plain version's bf16 ops round as the
    kernel's policy does), each launch counted as one; the errors fold into
    ``worst`` beside the fp32-compute ones. The direct kernels at their
    ragged shapes and a forced 3-plane x-chunk; every stencil kernel
    (direct1, direct2, the stream kernel, streamk k = 2..4) at
    (33,17,129) and 128^3; the Mehrstellen instances under
    ``HEAT3D_MEHRSTELLEN=1`` at the ragged shapes and 128^3; 7pt/27pt x
    fp32/bf16 storage x Dirichlet bc 0 and 0.3/periodic; the generic
    instances forced (both factoring knobs, and the direct kernels' generic
    instance on the default chain) at 128^3, fused over (4,1,1) too; the
    fused one- and two-update kernels over (8,1,1), the RDMA ones over
    (4,1,1) with the plan's sub-blocks (floor 0 and the default), and
    (8,77,125) over (2,1,1) in one and three send ranges; the fused
    generic instance forced on the generic programs
    (``_compare_fused_generic``); the Mehrstellen
    instances at the two-update instance's ragged shapes (``_QR_SHAPES``);
    and every instance on a field of subnormals, signed zeros, infinities
    and overflowing values (``_compare_bf16_special``)."""
    import numpy as np
    import torch

    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_stream as ss
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    t0 = time.perf_counter()
    bf = torch.bfloat16
    cases = {"direct_ragged": 0, "kernels": 0, "mehrstellen": 0, "generic": 0, "fused": 0,
             "fused_generic": 0, "special_values": 0}
    for shape in _QR_SHAPES:
        base = np.random.default_rng(17).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            with _env(HEAT3D_MEHRSTELLEN="1"):
                for periodic, bcv in _BCS:
                    cases["mehrstellen"] += _hold_mehrstellen_bf16(
                        worst, u, periodic, bcv,
                        f"bf16 compute at {shape} {dtype} periodic={periodic} bc={bcv}")
    cases["special_values"] += _compare_bf16_special(worst)
    shapes = [(shape, None) for shape in _DIRECT_SHAPES[:5]] + [_DIRECT_FORCED_CHUNK]
    for shape, chunk in shapes:
        base = np.random.default_rng(18).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                for periodic, bcv in _BCS:
                    for name, halo in _cases()[:2]:
                        what = f"bf16 compute at {shape} chunk {chunk} {dtype} {kind} " \
                               f"periodic={periodic} bc={bcv}"
                        _hold_bf16(worst, name, lambda: sd.launch_instance(
                            halo, sd.direct_instance(taps), u, taps, periodic, bcv,
                            xchunk=chunk, compute_dtype=bf),
                            _kernel_pair(name, halo, cd=bf)[1](u, taps, periodic, bcv), what)
                        cases["direct_ragged"] += 1
                with _env(HEAT3D_MEHRSTELLEN="1"):
                    for periodic, bcv in _BCS:
                        cases["mehrstellen"] += _hold_mehrstellen_bf16(
                            worst, u, periodic, bcv,
                            f"bf16 compute at {shape} chunk {chunk} {dtype} "
                            f"periodic={periodic} bc={bcv}", chunk)
    for shape in ((33, 17, 129), (128, 128, 128)):
        base = np.random.default_rng(19).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                for periodic, bcv in _BCS:
                    for name, k in _cases():
                        kern, plain = _kernel_pair(name, k, cd=bf)
                        x = _kernel_input(name, u, periodic, bcv, k)
                        _hold_bf16(worst, name, lambda: kern(x, taps, periodic, bcv),
                                   plain(x, taps, periodic, bcv),
                                   f"bf16 compute k={k} at {shape} {dtype} {kind} "
                                   f"periodic={periodic} bc={bcv}")
                        cases["kernels"] += 1
            if shape == (128, 128, 128):
                with _env(HEAT3D_MEHRSTELLEN="1"):
                    for periodic, bcv in _BCS:
                        cases["mehrstellen"] += _hold_mehrstellen_bf16(
                            worst, u, periodic, bcv,
                            f"bf16 compute at 128^3 {dtype} periodic={periodic} bc={bcv}")
            del u
        torch.cuda.empty_cache()

    # the generic instances: under both factoring knobs every chain is
    # generic; and the direct kernels' generic instance forced on the
    # default 7pt chain
    base = np.random.default_rng(20).standard_normal((128, 128, 128)).astype(np.float32)
    mesh4 = _card_mesh((4, 1, 1), (32, 128, 128))
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.from_numpy(base).cuda().to(dtype)
        us = _split(u, mesh4)
        with _env(HEAT3D_FACTOR_7PT="1", HEAT3D_FACTOR_Y="0"):
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                _check(ss.stream_instance(taps) == ss.GENERIC, f"{kind} not generic")
                for periodic, bcv in _BCS:
                    for name, k in _cases():
                        kern, plain = _kernel_pair(name, k, cd=bf)
                        x = _kernel_input(name, u, periodic, bcv, k)
                        before = _generic_counts()[name]
                        _hold_bf16(worst, name, lambda: kern(x, taps, periodic, bcv),
                                   plain(x, taps, periodic, bcv),
                                   f"bf16 compute generic k={k} at 128^3 {dtype} {kind} "
                                   f"periodic={periodic} bc={bcv}")
                        _check(_generic_counts()[name] == before + 1,
                               f"{name} {kind}: not on the generic instance")
                        cases["generic"] += 1
                for (periodic, bcv), name in itertools.product(
                        ((False, 0.3), (True, 0.0)),
                        ("apply_step_fused_dma", "apply_superstep_fused_dma")):
                    kern, plain = _fused_pair(name, cd=bf)
                    state = fd.FusedState(mesh4, _FUSED[name][0], dtype, periodic)
                    before = _generic_counts()[name]
                    _hold_bf16(worst, name, lambda: kern(us, taps, mesh4, state, periodic, bcv),
                               plain(us, taps, mesh4, None, periodic, bcv),
                               f"bf16 compute generic 128^3 on (4,1,1) {dtype} {kind} "
                               f"periodic={periodic}")
                    _check(_generic_counts()[name] == before + 1,
                           f"{name} {kind}: not on the generic instance")
                    cases["generic"] += 1
        taps = _taps("7pt")
        for name, halo in _cases()[:2]:
            _hold_bf16(worst, name, lambda: sd.launch_instance(
                halo, ss.GENERIC, u, taps, False, 0.3, compute_dtype=bf),
                _kernel_pair(name, halo, cd=bf)[1](u, taps, False, 0.3),
                f"bf16 compute generic instance forced on the 7pt chain, 128^3 {dtype}")
            cases["generic"] += 1
        del u, us
    torch.cuda.empty_cache()

    # the fused kernels
    base = torch.from_numpy(
        np.random.default_rng(21).standard_normal((128, 128, 128)).astype(np.float32)).cuda()
    for mesh_shape in ((8, 1, 1), (4, 1, 1)):
        mesh = _card_mesh(mesh_shape, tuple(128 // p for p in mesh_shape))
        names = [n for n in _FUSED if n.endswith("dma") == (mesh_shape == (8, 1, 1))]
        for kind, dtype, (periodic, bcv) in itertools.product(
                ("7pt", "27pt"), (torch.float32, torch.bfloat16),
                ((False, 0.3), (True, 0.0))):
            taps = _taps(kind)
            us = _split(base.to(dtype), mesh)
            for name in names:
                kern, plain = _fused_pair(name, cd=bf)
                for floor in ((0, None) if name.endswith("rdma") else (None,)):
                    state = _fused_state(mesh, name, dtype, periodic, floor)
                    _hold_bf16(worst, name, lambda: kern(us, taps, mesh, state, periodic, bcv),
                               plain(us, taps, mesh, None, periodic, bcv),
                               f"bf16 compute 128^3 on {mesh_shape} {kind} {dtype} "
                               f"periodic={periodic} ranges {state.bounds}")
                    cases["fused"] += 1
            del us
    del base
    mesh = _card_mesh((2, 1, 1), (4, 77, 125))
    base = torch.from_numpy(
        np.random.default_rng(22).standard_normal((8, 77, 125)).astype(np.float32)).cuda()
    for kind, dtype, (periodic, bcv) in itertools.product(
            ("7pt", "27pt"), (torch.float32, torch.bfloat16), ((False, 0.3), (True, 0.0))):
        taps = _taps(kind)
        us = _split(base.to(dtype), mesh)
        for name, parts in itertools.product(_FUSED, (1, 3)):
            kern, plain = _fused_pair(name, cd=bf)
            state = fd.FusedState(mesh, _FUSED[name][0], dtype, periodic,
                                  partition_bounds(77, parts))
            _hold_bf16(worst, name, lambda: kern(us, taps, mesh, state, periodic, bcv),
                       plain(us, taps, mesh, None, periodic, bcv),
                       f"bf16 compute (8,77,125) on (2,1,1) {kind} {dtype} "
                       f"periodic={periodic} ranges {state.bounds}")
            cases["fused"] += 1
    del base, us
    torch.cuda.empty_cache()
    cases["fused_generic"] = _compare_fused_generic(worst, bf)
    _say("compare_bf16", cases=cases, bitwise=True, max_abs_err=worst,
         compute_bf16_launches=_bf16_counts(), seconds=time.perf_counter() - t0)


def _compare_bf16_special(worst: dict) -> int:
    """Every bf16-compute instance bitwise against its plain version on
    ``_special_field`` (subnormal operands and results, signed zeros,
    infinities, sums that overflow; no NaN in any plain output): the
    direct kernels, the stream kernel and streamk k = 2..4 (7pt/27pt x
    fp32/bf16 storage x ``_BCS``), the Mehrstellen instances, and the four
    fused kernels over (8,1,1) / (4,1,1) at 128 x 64 x 96. The native bf16
    add and multiply keep subnormals and overflow as the float-then-round
    plain version does."""
    import torch

    bf = torch.bfloat16
    n = 0
    base = _special_field((37, 45, 131), 14)
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.from_numpy(base).cuda().to(dtype)
        for kind in ("7pt", "27pt"):
            taps = _taps(kind)
            for periodic, bcv in _BCS:
                for name, k in _cases():
                    kern, plain = _kernel_pair(name, k, cd=bf)
                    x = _kernel_input(name, u, periodic, bcv, k)
                    want = plain(x, taps, periodic, bcv)
                    _check(not bool(want.isnan().any()), f"{name} special field: NaN in plain")
                    _hold_bf16(worst, name, lambda: kern(x, taps, periodic, bcv), want,
                               f"bf16 compute special values k={k} {dtype} {kind} "
                               f"periodic={periodic} bc={bcv}")
                    n += 1
        with _env(HEAT3D_MEHRSTELLEN="1"):
            for periodic, bcv in _BCS:
                n += _hold_mehrstellen_bf16(worst, u, periodic, bcv,
                                            f"bf16 compute special values {dtype} "
                                            f"periodic={periodic} bc={bcv}")
    base = torch.from_numpy(_special_field((128, 64, 96), 15)).cuda()
    for mesh_shape in ((8, 1, 1), (4, 1, 1)):
        mesh = _card_mesh(mesh_shape, tuple(g // p for g, p in zip((128, 64, 96), mesh_shape)))
        names = [nm for nm in _FUSED if nm.endswith("dma") == (mesh_shape == (8, 1, 1))]
        us = _split(base, mesh)
        for kind, (periodic, bcv) in itertools.product(("7pt", "27pt"),
                                                       ((False, 0.3), (True, 0.0))):
            taps = _taps(kind)
            for name in names:
                kern, plain = _fused_pair(name, cd=bf)
                state = _fused_state(mesh, name, torch.float32, periodic)
                _hold_bf16(worst, name, lambda: kern(us, taps, mesh, state, periodic, bcv),
                           plain(us, taps, mesh, None, periodic, bcv),
                           f"bf16 compute special values on {mesh_shape} {kind} "
                           f"periodic={periodic}")
                n += 1
        del us
    del base
    torch.cuda.empty_cache()
    return n


def _hold_mehrstellen_bf16(worst: dict, u, periodic, bcv, what, chunk=None) -> int:
    """Both Mehrstellen instances in bf16 compute on ``u`` (27pt, the knob
    on), bitwise against their plain versions, each counted as a
    bf16-compute Mehrstellen launch."""
    import torch

    from heat3d_tpu_torch.ops import stencil_direct as sd

    bf = torch.bfloat16
    taps = _taps("27pt")
    for name, (wrapper, halo) in _MEHR.items():
        _hold_bf16(worst, name, lambda: sd.launch_instance(
            halo, sd.MEHRSTELLEN, u, taps, periodic, bcv, xchunk=chunk, compute_dtype=bf),
            _kernel_pair(wrapper, halo, cd=bf)[1](u, taps, periodic, bcv), what, counted=name)
    return len(_MEHR)


# interior x-chunks a shard that fused_times sweeps the compile-time
# instances over (ms_by_xchunks)
_FUSED_CHUNK_SWEEP = (1, 2, 3, 4, 6, 8, 12)


def phase_fused_times(bw: float, worst: dict, resources: dict) -> dict:
    """Each fused kernel's ms per launch at 1024^3 fp32 7pt Dirichlet bc 0,
    one launch over all shards of the card (the DMA kernels on (8,1,1), the
    RDMA kernels on (4,1,1) with the partitioned plan's default sub-blocks:
    the full-width rows' meshes), its plain version's ms, and its bound:
    the field read once and written once plus each x-face slab sent read
    and written once; with the instance's registers, spills and resident
    blocks per SM. Each kernel runs on its compile-time 7pt instance (also
    at 1 to 12 interior x-chunks a shard, ``ms_by_xchunks``) and, timed in
    the same call, on the generic instance forced on the 7pt chain and on
    the advection-diffusion vx=2 program (``generic_ms``,
    ``generic_advection_ms``), which must stay within 1.6x (one update) /
    2.0x (two) of the compile-time instance; the DMA kernels also over
    (2,1,1) (``ms_on_2x1x1``: two 512-plane shards,
    little skin and push). Each timed launch is held bitwise to its plain
    version. The one-update kernels' result over all shards is one update
    of the 1024^3 field: their library call is one cuDNN convolution (TF32
    off, never called by the port) over the shards joined and padded with
    bc, held to the kernel within the rounding bound; the shard split and
    the padding are data layout, left out of the time as for row 1. No
    single PyTorch call computes two updates, so the two-update kernels
    have no library time."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    n = 1024
    taps = _taps("7pt", n)
    flops = flops_per_update(taps)
    times = {}
    for name, mesh_shape in (("apply_step_fused_dma", (8, 1, 1)),
                             ("apply_superstep_fused_dma", (8, 1, 1)),
                             ("apply_step_fused_rdma", (4, 1, 1)),
                             ("apply_superstep_fused_rdma", (4, 1, 1))):
        k = _FUSED[name][0]
        mesh = _card_mesh(mesh_shape, tuple(n // p for p in mesh_shape))
        us = [torch.rand(mesh.local_shape, device=s.device) for s in mesh.shards]
        outs = [torch.empty_like(u) for u in us]
        kern, plain = _fused_pair(name)
        state = _fused_state(mesh, name, torch.float32, False)
        want = plain(us, taps, mesh, None, False, 0.0)
        inst = fd.fused_instance(k, taps)

        def go(instance=None, dst=outs, xchunk=None, taps=taps):
            mesh.fork()
            if instance is None:
                kern(us, taps, mesh, state, False, 0.0, outs=dst)
            else:
                fd.launch_instance(instance, us, taps, mesh, state, False, 0.0, outs=dst,
                                   wrapper=_fused_wrapper(name), xchunk=xchunk)
            mesh.join()

        ms = _time_ms(go, iters=10)
        _hold_fused(worst, name, outs, want, f"at {n}^3 on {mesh_shape}")
        plain_ms = _time_ms(lambda: plain(us, taps, mesh, None, False, 0.0), iters=3)
        b_ms, by, moved = fused_bound(n, mesh_shape, k, 4, flops, bw)
        res = resources[f"fused_h{k}_{_instance_name(inst)}_float32"]
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                       "library_ms": None, "bytes": moved, "mesh": list(mesh_shape),
                       "send_ranges": [list(b) for b in state.bounds],
                       "instance": _instance_name(inst),
                       "kernel": (f"fused_chain_kernel<float,{k},{_instance_name(inst)}>"
                                  if inst else f"fused_generic<float,{k},F32Math>"),
                       "xchunk": fd._launch_xchunk(k, inst, tuple(mesh.local_shape),
                                                   len(mesh), 0, torch.float32),
                       **{f: res[f] for f in ("blocks_per_sm", "registers", "spill_stores",
                                              "spill_loads")}}
        # the interior cut into c x-chunks a shard (each re-reads 2k planes)
        inner = mesh.local_shape[0] - 2 * k
        sweep = {}
        for c in _FUSED_CHUNK_SWEEP:
            swept = [torch.empty_like(u) for u in us]
            sweep[c] = _time_ms(lambda: go(inst, swept, -(-inner // c)), iters=5)
            _hold_fused(worst, name, swept, want,
                        f"{c} x-chunks at {n}^3 on {mesh_shape}")
        times[name]["ms_by_xchunks"] = sweep
        del swept
        # the generic instance forced on the 7pt chain and on the
        # advection-diffusion vx=2 program, each last launch held bitwise
        outs_generic = [torch.empty_like(u) for u in us]
        gres = resources[f"fused_h{k}_generic_float32"]
        times[name]["generic"] = {
            "kernel": f"fused_generic<float,{k},F32Math>",
            "xchunk": fd._launch_xchunk(k, 0, tuple(mesh.local_shape), len(mesh), 0,
                                        torch.float32),
            **{f: gres[f] for f in ("blocks_per_sm", "registers", "spill_stores",
                                    "spill_loads")}}
        for key, t in (("generic", taps), ("generic_advection", _advection_taps(n))):
            gms = _time_ms(lambda: go(0, outs_generic, taps=t), iters=10)
            _hold_fused(worst, name, outs_generic,
                        want if t is taps else plain(us, t, mesh, None, False, 0.0),
                        f"{key} instance at {n}^3 on {mesh_shape}")
            times[name][f"{key}_ms"] = gms
            times[name][f"{key}_bound_ms"] = fused_bound(n, mesh_shape, k, 4,
                                                         flops_per_update(t), bw)[0]
        # the generic sweep within 1.6x (one update) / 2.0x (two) of the
        # compile-time instance: the first design ran 2.3x / 3.7x
        limit = 1.6 if k == 1 else 2.0
        _check(times[name]["generic_ms"] <= limit * ms,
               f"{name}: generic instance {times[name]['generic_ms']} ms over {limit} x "
               f"the compile-time instance's {ms} ms at {n}^3 on {mesh_shape}")
        del outs_generic
        if k == 1:
            torch.backends.cudnn.allow_tf32 = False
            w = torch.from_numpy(np.asarray(taps, dtype=np.float32)).cuda()[None, None]
            up = F.pad(torch.cat(us), (1, 1, 1, 1, 1, 1), value=0.0)[None, None]
            times[name]["library_ms"] = _time_ms(lambda: F.conv3d(up, w), iters=3)
            times[name].update(_library_check(name, torch.cat(outs),
                                              F.conv3d(up, w)[0, 0], taps, up))
            del up
        del us, outs, state, want
        torch.cuda.empty_cache()
    # the DMA kernels over (2,1,1), two 512-plane shards, where the skin
    # planes and the pushes are a small part of the launch: the sweep beside
    # the direct kernels' (kernel_times)
    mesh = _card_mesh((2, 1, 1), (n // 2, n, n))
    us = [torch.rand(mesh.local_shape, device=s.device) for s in mesh.shards]
    outs = [torch.empty_like(u) for u in us]
    for name in ("apply_step_fused_dma", "apply_superstep_fused_dma"):
        kern, plain = _fused_pair(name)
        state = _fused_state(mesh, name, torch.float32, False)

        def go2():
            mesh.fork()
            kern(us, taps, mesh, state, False, 0.0, outs=outs)
            mesh.join()

        times[name]["ms_on_2x1x1"] = _time_ms(go2, iters=10)
        _hold_fused(worst, name, outs, plain(us, taps, mesh, None, False, 0.0),
                    f"at {n}^3 on (2, 1, 1)")
        del state
    del us, outs
    torch.cuda.empty_cache()
    _say("fused_times", grid=[n, n, n], stencil="7pt", dtype="float32", bc_value=0.0,
         times=times, bitwise=True, max_abs_err={k: worst[k] for k in _FUSED})
    return times


def phase_cross_gpu(worst: dict) -> None:
    """The (2,1,1) DMA check with shard 0 on cuda:0 and shard 1 on cuda:1:
    peer stores across GPUs. Runs only with two GPUs visible."""
    import numpy as np
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        _say("cross_gpu", ran=False,
             reason=f"{count} CUDA device visible; the phase needs 2 (the peer "
                    "writes of the DMA and fused kernels between GPUs stay "
                    "unchecked by this run)")
        return
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    mesh = _card_mesh((2, 1, 1), (64, 128, 128), devices)
    base = torch.from_numpy(
        np.random.default_rng(5).standard_normal((128, 128, 128)).astype(np.float32)).cuda()
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        us = _split(base.to(dtype), mesh)
        for periodic, bcv in _BCS:
            for width in (1, 2, 3, 4):
                got, want = _exchange_pair(mesh, us, periodic, bcv, width, dtype)
                for d in devices:
                    torch.cuda.synchronize(d)
                _hold_blocks(worst, [g.cpu() for g in got], [w.cpu() for w in want],
                             f"across GPUs width {width} {dtype} periodic={periodic}")
                cases += 1
    bursts = _dma_burst(worst, mesh, _split(base, mesh), True, 0.0, 4)
    # the fused kernels: one launch per GPU, the pushes peer stores
    fused = 0
    for dtype in (torch.float32, torch.bfloat16):
        us = _split(base.to(dtype), mesh)
        for periodic, bcv in ((False, 0.3), (True, 0.0)):
            for name in _FUSED:
                kern, plain = _fused_pair(name)
                for floor in ((0, None) if name.endswith("rdma") else (None,)):
                    state = _fused_state(mesh, name, dtype, periodic, floor)
                    for _ in range(5):
                        got = kern(us, _taps("27pt"), mesh, state, periodic, bcv)
                        for d in devices:
                            torch.cuda.synchronize(d)
                        _hold_fused(worst, name, [g.cpu() for g in got],
                                    [w.cpu() for w in plain(us, _taps("27pt"), mesh, None,
                                                            periodic, bcv)],
                                    f"across GPUs {dtype} periodic={periodic}")
                        fused += 1
    _say("cross_gpu", ran=True, devices=[str(d) for d in devices], dma_cases=cases,
         dma_exchanges_in_a_row=bursts, fused_cases=fused, bitwise=True)


# the multiprocess phase: the command line as two ranks over a localhost
# rendezvous, every shard of both on cuda:0 (--device cuda:0), each launch
# under a timeout. Golden runs at 128^3 on (2,2,2), 20 steps: (flags,
# HEAT3D_NO_DIRECT, the kernel every rank must launch)
_MP_GOLDEN = ((["--time-blocking", "1"], False, "apply_taps_direct"),
              (["--time-blocking", "2"], False, "apply_taps_direct2"),
              (["--time-blocking", "1"], True, "apply_taps_stream"),
              (["--time-blocking", "4"], False, "apply_taps_streamk"))
# the routes that store into peer memory, across the two ranks on the peer
# wire, 128^3 goldens: (mesh, flags, environment, the kernels every rank
# must launch)
_MP_PEER = (
    ((2, 2, 2), ["--halo", "dma", "--time-blocking", "1"], {},
     ("halo_dma", "apply_taps_stream")),
    ((2, 2, 2), ["--halo", "dma", "--time-blocking", "4"], {},
     ("halo_dma", "apply_taps_streamk")),
    ((2, 2, 2), ["--halo", "dma", "--overlap"], {}, ("apply_step_fused_dma",)),
    ((8, 1, 1), ["--halo", "dma", "--overlap", "--time-blocking", "1"], {},
     ("apply_step_fused_dma",)),
    ((8, 1, 1), ["--halo", "dma", "--overlap", "--time-blocking", "2"], {},
     ("apply_superstep_fused_dma",)),
    ((4, 1, 1), ["--fused-rdma", "on", "--halo-plan", "partitioned", "--time-blocking", "1"],
     {"HEAT3D_PLAN_PART_MIN_BYTES": "0"}, ("apply_step_fused_rdma",)),
    ((4, 1, 1), ["--fused-rdma", "on", "--halo-plan", "partitioned", "--time-blocking", "2"],
     {"HEAT3D_PLAN_PART_MIN_BYTES": "0"}, ("apply_superstep_fused_rdma",)),
)
# two-rank runs at once in the golden batches
_MP_BATCH = 6
_MP_N = 128
_MP_FULL = 1024
# the 1024^3 runs, 10 steps each: (mesh, flags, HEAT3D_WIRE, the superstep route)
_MP_FULL_RUNS = (((2, 2, 2), ["--time-blocking", "2"], "peer", "faces-direct2"),
                 ((2, 2, 2), ["--time-blocking", "2"], "host", "faces-direct2"),
                 ((8, 1, 1), ["--halo", "dma", "--overlap", "--time-blocking", "2"], "peer",
                  "fused-dma2"))
_MP_TIMEOUT_S = 240
# the ranks' process-group timeout: a lost peer fails before the launch's
_MP_DIST_TIMEOUT_S = "120"
_PEER_COUNTS = ("peer_signal", "peer_wait")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mp_start(argv, root: str, env=None, visible=None) -> dict:
    """Start the port's command line as two ranks (``--coordinator``
    ``--num-processes 2 --process-id p``), output captured to files under
    ``root``; rank p sees ``CUDA_VISIBLE_DEVICES=visible[p]`` when given."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    base = dict(os.environ, PYTHONPATH=here, HEAT3D_DIST_TIMEOUT_S=_MP_DIST_TIMEOUT_S,
                **(env or {}))
    run = {"argv": argv, "procs": [], "t0": time.perf_counter()}
    try:
        for rank in (0, 1):
            out = open(os.path.join(root, f"mp{port}-{rank}.out"), "w+")
            err = open(os.path.join(root, f"mp{port}-{rank}.err"), "w+")
            e = dict(base, **({"CUDA_VISIBLE_DEVICES": visible[rank]} if visible else {}))
            run["procs"].append((subprocess.Popen(
                [sys.executable, "-m", "heat3d_tpu_torch", *argv, "--coordinator",
                 f"localhost:{port}", "--num-processes", "2", "--process-id", str(rank)],
                env=e, stdout=out, stderr=err, cwd=here), out, err))
    except BaseException:
        _mp_stop(run)
        raise
    return run


def _mp_stop(run: dict) -> None:
    """Kill what still runs of a two-rank run and close its files."""
    for p, out, err in run["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()
        err.close()


def _mp_finish(run: dict) -> tuple:
    """Wait for a two-rank run under ``_MP_TIMEOUT_S``; fails unless both
    ranks exit 0 and rank 0 alone prints the summary. Returns (rank 0's
    summary, seconds)."""
    argv, outs = run["argv"], []
    try:
        for p, out, err in run["procs"]:
            try:
                p.wait(timeout=max(1.0, _MP_TIMEOUT_S - (time.perf_counter() - run["t0"])))
            except subprocess.TimeoutExpired:
                _check(False, f"two-rank run {argv} passed its {_MP_TIMEOUT_S} s limit")
            out.seek(0)
            err.seek(0)
            outs.append((p.returncode, out.read(), err.read()))
    finally:
        _mp_stop(run)
    seconds = time.perf_counter() - run["t0"]
    for rank, (rc, out, err) in enumerate(outs):
        _check(rc == 0, f"rank {rank} of {argv} exited {rc}: {err[-3000:]}")
    lines = [[ln for ln in out.splitlines() if ln.startswith("{")] for _, out, _ in outs]
    _check(len(lines[0]) == 1 and not lines[1],
           f"{argv}: rank 0 printed {len(lines[0])} summaries, rank 1 {len(lines[1])}")
    return json.loads(lines[0][0]), seconds


def _mp_launch(argv, root: str, env=None, visible=None) -> tuple:
    """A two-rank run from start to finish (:func:`_mp_finish`)."""
    return _mp_finish(_mp_start(argv, root, env, visible))


def _mp_one(argv, env=None) -> dict:
    """The same command line as one process, in this process, under
    ``env``."""
    from heat3d_tpu_torch import cli

    buf = io.StringIO()
    with _env(**(env or {})), contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    _check(rc == 0, f"one-process run {argv} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _mp_transport(two: dict, want: str, argv) -> None:
    """Both ranks ran on the ``want`` wire, and only the peer wire
    launched peer signals and waits."""
    got = [w["transport"] for w in two["process_wire"]]
    _check(got == [want, want], f"{argv}: transports {got}, want {want}")
    for rank, counts in enumerate(two["process_kernel_launches"]):
        peer = [counts[k] for k in _PEER_COUNTS]
        _check(all(peer) if want == "peer" else not any(peer),
               f"{argv}: rank {rank} peer launches {peer} on the {want} wire")


def _mp_golden(root: str, smi: str) -> dict:
    """The 128^3 golden runs as two ranks, ``_MP_BATCH`` pairs at once:
    the four kernel routes of ``_MP_GOLDEN`` and the peer-store routes of
    ``_MP_PEER`` on the default wire (peer), faces-direct tb=1 also on
    ``HEAT3D_WIRE=host``; each against one process, bitwise."""
    arms = [((2, 2, 2), flags, {"HEAT3D_NO_DIRECT": "1"} if no_direct else {}, (want,), "peer")
            for flags, no_direct, want in _MP_GOLDEN]
    arms += [(mesh, flags, env, wants, "peer") for mesh, flags, env, wants in _MP_PEER]
    arms.append(((2, 2, 2), ["--time-blocking", "1"], {"HEAT3D_WIRE": "host"},
                 ("apply_taps_direct",), "host"))
    launched = {}
    for b in range(0, len(arms), _MP_BATCH):
        batch, runs = arms[b:b + _MP_BATCH], []
        try:
            for mesh, flags, env, _, _ in batch:
                argv = ["--grid", str(_MP_N), "--mesh", *map(str, mesh), "--steps", "20",
                        "--device", "cuda:0", "--golden-check", *flags]
                runs.append(_mp_start(argv, root, env))
            pairs = [_mp_finish(run) for run in runs]
        finally:
            for run in runs:
                _mp_stop(run)
        for run, (two, seconds), (mesh, flags, env, wants, transport) in zip(runs, pairs, batch):
            argv = run["argv"]
            one = _mp_one(argv, {k: v for k, v in env.items() if k != "HEAT3D_WIRE"})
            _check(two["golden_pass"] is True, f"two ranks failed the golden check: {two}")
            _check(two["residual_l2"] == one["residual_l2"],
                   f"{argv}: two ranks' residual {two['residual_l2']!r} != one process's "
                   f"{one['residual_l2']!r}")
            _check((two["step_route"], two["superstep_route"])
                   == (one["step_route"], one["superstep_route"]),
                   f"{argv}: routes {two['step_route']}/{two['superstep_route']} vs one "
                   f"process's {one['step_route']}/{one['superstep_route']}")
            _mp_transport(two, transport, argv)
            per_rank = two["process_kernel_launches"]
            for rank, counts in enumerate(per_rank):
                for want in wants:
                    _check(counts[want] > 0,
                           f"rank {rank} of {argv} did not launch {want}: {counts}")
                for name, n in counts.items():
                    launched[name] = launched.get(name, 0) + n
            _say("multiprocess_golden", card=smi, processes=two["processes"], mesh=list(mesh),
                 flags=flags, env=env, transport=transport,
                 step_route=two["step_route"], superstep_route=two["superstep_route"],
                 golden_pass=True, golden_rel_err=two["golden_rel_err"],
                 residual_l2=two["residual_l2"], residual_equal_to_one_process=True,
                 rank_launches={w: [c[w] for c in per_rank] for w in wants + _PEER_COUNTS},
                 process_wire=two["process_wire"], seconds=seconds)
    for want in {w for arm in arms for w in arm[3]}:
        _check(launched.get(want, 0) > 0, f"{want} was not launched by the two-rank runs")
    return launched


def _mp_state(root: str, smi: str) -> None:
    """A 128^3 (2,2,2) checkpoint at step 5 by two ranks, resumed by two
    ranks to step 10: every shard file and the residual equal to one
    process's uninterrupted 10 steps."""
    base = ["--grid", str(_MP_N), "--mesh", "2", "2", "2", "--device", "cuda:0",
            "--time-blocking", "2"]
    ck, ref = os.path.join(root, "mp-ck"), os.path.join(root, "mp-ref")
    _mp_launch([*base, "--steps", "5", "--checkpoint", ck], root)
    resumed, seconds = _mp_launch([*base, "--steps", "5", "--checkpoint", ck, "--resume"], root)
    clean = _mp_one([*base, "--steps", "10", "--checkpoint", ref])
    _check(resumed["residual_l2"] == clean["residual_l2"],
           f"resumed residual {resumed['residual_l2']!r} != {clean['residual_l2']!r}")
    with open(os.path.join(ck, "manifest.json")) as f:
        man = json.load(f)
    _check(man["step"] == 10 and len(man["shards"]) == 8, f"manifest {man}")
    names = sorted(n for n in os.listdir(ref) if n.startswith("shard_"))
    _check(len(names) == 16, f"the one-process save wrote {names}")
    for name in names:
        with open(os.path.join(ck, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            _check(a.read() == b.read(), f"{name} of the resumed two-rank run differs")
    _say("multiprocess_state", card=smi, manifest_shards=len(man["shards"]),
         manifest_step=man["step"], shard_files_byte_equal=len(names),
         residual_equal_to_one_process=True, resume_seconds=seconds)


def _mp_full(root: str, smi: str) -> None:
    """1024^3 fp32 7pt, 10 steps, each run of ``_MP_FULL_RUNS`` as two ranks
    against one process (bitwise), with both Gcell/s and each rank's wire
    host milliseconds per round that carried faces. The two ranks share
    one card as two time-sliced contexts: no speed claim."""
    for mesh, flags, transport, route in _MP_FULL_RUNS:
        argv = ["--grid", str(_MP_FULL), "--mesh", *map(str, mesh), "--device", "cuda:0",
                "--steps", "10", *flags]
        two, seconds = _mp_launch(argv, root, {"HEAT3D_WIRE": transport})
        one = _mp_one(argv)
        _check(two["superstep_route"] == route, f"{argv}: route {two['superstep_route']}")
        _check(two["residual_l2"] == one["residual_l2"],
               f"1024^3 {argv} on the {transport} wire: two ranks' residual "
               f"{two['residual_l2']!r} != one process's {one['residual_l2']!r}")
        _mp_transport(two, transport, argv)
        wire = two["process_wire"]
        _say("multiprocess_full_width", card=smi, grid=[_MP_FULL] * 3, mesh=two["mesh"],
             flags=flags, transport=transport, superstep_route=route,
             shards_per_rank=mesh[0] * mesh[1] * mesh[2] // 2, steps=two["steps"],
             residual_l2=two["residual_l2"], residual_equal_to_one_process=True,
             gcell_updates_per_sec=two["gcell_updates_per_sec"],
             one_process_gcell_updates_per_sec=one["gcell_updates_per_sec"],
             rank_launches=[{k: v for k, v in c.items() if v}
                            for c in two["process_kernel_launches"]],
             process_wire=wire,
             wire_host_ms_per_round=[1e3 * w["seconds"] / max(w["rounds"], 1) for w in wire],
             seconds=seconds)


def phase_multiprocess(smi: str) -> dict:
    """The multi-process form (one process per GPU, ``--coordinator``):
    the 128^3 goldens (the peer-store routes on the peer wire, one arm on
    the host wire), the checkpoint resumed across ranks, the 1024^3 runs,
    each held bitwise to one process; one rank per GPU when two are
    visible."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="heat3d_mp_")
    try:
        launched = _mp_golden(root, smi)
        _mp_state(root, smi)
        _mp_full(root, smi)
        count = torch.cuda.device_count()
        if count >= 2:
            argv = ["--grid", str(_MP_N), "--mesh", "2", "2", "2", "--steps", "20",
                    "--device", "cuda:0", "--golden-check", "--time-blocking", "2"]
            # each rank on its own card, seeing the other's (the peer wire
            # maps it)
            two, seconds = _mp_launch(argv, root, visible=("0,1", "1,0"))
            one = _mp_one(argv)
            _check(two["golden_pass"] is True and two["residual_l2"] == one["residual_l2"],
                   f"one rank per GPU: {two['residual_l2']!r} vs {one['residual_l2']!r}")
            _say("multiprocess_cross_gpu", card=smi, cross_gpu_ranks=True, seconds=seconds,
                 residual_equal_to_one_process=True)
        else:
            _say("multiprocess_cross_gpu", card=smi, cross_gpu_ranks=False,
                 reason=f"{count} CUDA device visible; one rank per GPU needs 2 (both "
                        "ranks ran on cuda:0)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _say("multiprocess", seconds=time.perf_counter() - t0, kernel_launches=launched)
    return launched


def _mehrstellen_counts(cells: bool = False) -> dict:
    """Launches (or output cells) of the Mehrstellen instances, keyed as
    ``_MEHR``."""
    from heat3d_tpu_torch.ops import stencil_direct as sd

    counts = sd.mehrstellen_cell_counts() if cells else sd.mehrstellen_launch_counts()
    return {f"{name}:mehrstellen": n for name, n in counts.items()}


def _hold_mehrstellen(worst: dict, u, periodic, bcv, what, chunk=None) -> int:
    """Both direct wrappers on ``u`` under ``HEAT3D_MEHRSTELLEN`` (27pt):
    each launch on the Mehrstellen instance (counted as such; ``chunk``
    forces the x-chunk) and bitwise equal to its plain version."""
    from heat3d_tpu_torch.ops import stencil_direct as sd

    taps = _taps("27pt")
    for name, (wrapper, halo) in _MEHR.items():
        kern, plain = _kernel_pair(wrapper, halo)
        before = _mehrstellen_counts()[name]
        if chunk is None:
            got = kern(u, taps, periodic, bcv)
        else:
            got = sd.launch_instance(halo, sd.MEHRSTELLEN, u, taps, periodic, bcv,
                                     xchunk=chunk)
        _hold(worst, name, got, plain(u, taps, periodic, bcv), what)
        _check(_mehrstellen_counts()[name] == before + 1,
               f"{name} {what}: not launched on the Mehrstellen instance")
    return len(_MEHR)


# (time_blocking, route, mesh, knobs) of the 27pt routes
# that keep the tap chain under HEAT3D_MEHRSTELLEN, as the JAX kernels do
_MEHR_CHAIN_ROUTES = ((4, "streamk", (1, 1, 1), {}),
                      (2, "fused-dma2", (8, 1, 1), {"halo": "dma", "overlap": True}))


def phase_compare_mehrstellen(worst: dict) -> None:
    """Under ``HEAT3D_MEHRSTELLEN=1``: both Mehrstellen instances bitwise
    against their plain versions at the direct kernels' ragged shapes and
    the two-update instance's (``_QR_SHAPES``), a forced 3-plane x-chunk,
    128^3 and 1024^3 (fp32/bf16 x Dirichlet bc 0 and 0.3/periodic); the
    (2,2,2) faces-direct solve against the (1,1,1)
    solve at 128^3 (tb 1 and 2, fp32/bf16, Dirichlet 0.3/periodic), every
    shard on cuda:0; and the routes that keep the chain (27pt tb=4 streamk,
    fused-dma2 over (8,1,1)) equal to their knob-off solves, no Mehrstellen
    launch among them."""
    import torch

    t0 = time.perf_counter()
    cases = 0
    shapes = ([(shape, None) for shape in _DIRECT_SHAPES + _QR_SHAPES] + [_DIRECT_FORCED_CHUNK]
              + [((128,) * 3, None), ((1024,) * 3, None)])
    gen = torch.Generator(device="cuda").manual_seed(10)
    with _env(HEAT3D_MEHRSTELLEN="1"):
        for shape, chunk in shapes:
            base = torch.randn(shape, generator=gen, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                u = base.to(dtype)
                for periodic, bcv in _BCS:
                    cases += _hold_mehrstellen(
                        worst, u, periodic, bcv,
                        f"at {shape} chunk {chunk} {dtype} periodic={periodic} bc={bcv}", chunk)
                del u
            del base
            torch.cuda.empty_cache()
        solves = []
        for tb in (1, 2):
            for storage in ("float32", "bfloat16"):
                for periodic in (False, True):
                    bcv = 0.0 if periodic else 0.3
                    before = sum(_mehrstellen_counts().values())
                    want = _solve_gathered(128, (1, 1, 1), "27pt", storage, periodic, bcv, tb, 20)
                    got = _solve_gathered(128, _MESH, "27pt", storage, periodic, bcv, tb, 20,
                                          device="cuda:0")
                    _check(sum(_mehrstellen_counts().values()) > before,
                           f"no Mehrstellen launch in the tb={tb} solves")
                    _check(got.tobytes() == want.tobytes(),
                           f"faces-direct solve != (1,1,1) solve under the knob: tb={tb} "
                           f"{storage} periodic={periodic}")
                    solves.append([tb, storage, periodic])
    chain = []
    for tb, route, mesh, knobs in _MEHR_CHAIN_ROUTES:
        device = None if mesh == (1, 1, 1) else "cuda:0"
        want = _solve_gathered(128, mesh, "27pt", "float32", False, 0.3, tb, 20, device=device,
                               **knobs)
        with _env(HEAT3D_MEHRSTELLEN="1"):
            before = _mehrstellen_counts()
            got = _solve_gathered(128, mesh, "27pt", "float32", False, 0.3, tb, 20,
                                  device=device, **knobs)
            _check(_mehrstellen_counts() == before, f"{route} launched a Mehrstellen instance")
        _check(got.tobytes() == want.tobytes(), f"{route} under the knob != knob off")
        chain.append(route)
    _say("compare_mehrstellen", cases=cases, bitwise=True,
         max_abs_err={name: worst[name] for name in _MEHR},
         sharded_vs_single_solves=solves, chain_routes_equal_knob_off=chain,
         mehrstellen_launches=_mehrstellen_counts(), seconds=time.perf_counter() - t0)


def _golden_mehrstellen() -> None:
    """The command line at 128^3 under ``HEAT3D_MEHRSTELLEN=1``, 27pt tb 1
    and 2, fp32 and bf16 storage, ``--golden-check``: each run launches the
    Mehrstellen instance."""
    for tb, want in ((1, "apply_taps_direct"), (2, "apply_taps_direct2")):
        for dtype in ("fp32", "bf16"):
            with _env(HEAT3D_MEHRSTELLEN="1"):
                before = _mehrstellen_counts()[f"{want}:mehrstellen"]
                _golden_cli(["--grid", "128", "--steps", "20", "--stencil", "27pt",
                             "--time-blocking", str(tb), "--dtype", dtype], want,
                            stencil="27pt", time_blocking=tb, dtype=dtype, mehrstellen=True)
                _check(_mehrstellen_counts()[f"{want}:mehrstellen"] > before,
                       f"golden tb={tb} {dtype}: no Mehrstellen launch")


# (time_blocking, storage, mesh, knobs, Mehrstellen route) of the full-width
# rows under HEAT3D_MEHRSTELLEN=1, 27pt: the direct routes on the
# Mehrstellen instance, the exchange path and the fused route on the chain
_MEHR_FULL_WIDTH = (
    (2, "float32", (1, 1, 1), {}, True), (1, "float32", (1, 1, 1), {}, True),
    (2, "bfloat16", (1, 1, 1), {}, True), (1, "float32", _MESH, {}, True),
    (2, "float32", _MESH, {}, True), (4, "float32", (1, 1, 1), {}, False),
    (2, "float32", (8, 1, 1), {"halo": "dma", "overlap": True}, False),
)


def _full_width_mehrstellen(bw: float) -> None:
    """The full-width rows under the knob (``_MEHR_FULL_WIDTH``), each
    beside its bound; then the (2,2,2) faces-direct solve at 1024^3 held
    bitwise to the (1,1,1) solve (tb 1 and 2, 4 steps, hot cube)."""
    import torch

    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.ops import stencil_direct as sd

    n = 1024
    with _env(HEAT3D_MEHRSTELLEN="1"):
        for tb, storage, mesh, knobs, q_ring in _MEHR_FULL_WIDTH:
            cfg = SolverConfig(grid=GridConfig.cube(n), stencil=StencilConfig(kind="27pt"),
                               precision=Precision(storage=storage),
                               mesh=MeshConfig(shape=mesh), time_blocking=tb, **knobs)
            before = sum(_mehrstellen_counts().values())
            row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3,
                                   device=None if mesh == (1, 1, 1) else "cuda:0")
            took = sum(_mehrstellen_counts().values()) - before
            route = row["superstep_route"] if tb > 1 else row["step_route"]
            _check(row["mehrstellen_route"] is q_ring and (took > 0) is q_ring,
                   f"{route} under the knob: mehrstellen_route {row['mehrstellen_route']}, "
                   f"{took} Mehrstellen launches")
            itemsize = torch.empty((), dtype=getattr(torch, storage)).element_size()
            flops = sd.MEHRSTELLEN_KERNEL_OPS if q_ring else flops_per_update(_taps("27pt"))
            if mesh == (1, 1, 1):
                b_ms, by = superstep_bound(route, n, tb, itemsize, flops, bw)
            else:
                b_ms, by, _ = sharded_superstep_bound(route, n, mesh, tb, itemsize, flops, bw)
            _say("full_width", grid=row["grid"], stencil="27pt", dtype=storage, mehrstellen=True,
                 mesh=row["mesh"], halo=row["halo"], overlap=row["overlap"], time_blocking=tb,
                 route=route, mehrstellen_route=row["mehrstellen_route"],
                 chain_ops=row["chain_ops"], mehrstellen_launches=took, steps=row["steps"],
                 gcell_updates_per_sec=row["gcell_updates_per_sec"],
                 ms_per_superstep=row["ms_per_launch"], bound_ms_per_superstep=b_ms,
                 bound_by=by, bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
                 kernel_launches=row["kernel_launches"], seconds_all=row["seconds_all"])
            del row
            torch.cuda.empty_cache()
        for tb in (1, 2):
            fields = {}
            for mesh in ((1, 1, 1), _MESH):
                cfg = SolverConfig(grid=GridConfig.cube(n), stencil=StencilConfig(kind="27pt"),
                                   mesh=MeshConfig(shape=mesh), time_blocking=tb)
                solver = HeatSolver3D(cfg, device="cuda:0")
                fields[mesh] = solver.run(solver.init_state("hot-cube"), 4)
                del solver
            whole = _shard_list(fields[(1, 1, 1)])[0]
            m = n // _MESH[0]
            equal = all(
                torch.equal(fields[_MESH][c], whole[c[0] * m:(c[0] + 1) * m,
                                                    c[1] * m:(c[1] + 1) * m,
                                                    c[2] * m:(c[2] + 1) * m])
                for c in itertools.product(range(2), repeat=3))
            _check(equal, f"faces-direct tb={tb} at {n}^3 != (1,1,1) under the knob")
            _say("full_width_sharded_bitwise", grid=[n] * 3, mesh=list(_MESH), stencil="27pt",
                 time_blocking=tb, steps=4, mehrstellen=True, bitwise=True)
            del fields, whole
            torch.cuda.empty_cache()


def phase_mehrstellen_times(bw: float, worst: dict, resources: dict) -> dict:
    """The Mehrstellen instances at 1024^3 (27pt, Dirichlet bc 0), fp32 and
    bf16, beside the 27pt chain instances of the same call (the knob off):
    ms per launch, bound (bytes, or the instance's own fp32 operations),
    registers, spills and blocks per SM, each launch held bitwise to its
    plain version; fp32 also the plain version's time and, at tb=1, the
    library call (one cuDNN 27pt convolution, TF32 off, never called by the
    port) held to the kernel within a rounding bound. Returns the fp32
    numbers of each instance, keyed as ``_MEHR``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops.stencil_eager import pad_local

    n = 1024
    taps = _taps("27pt", n)
    variants, res = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.rand((n, n, n), device="cuda").to(dtype)
        out = torch.empty_like(u)
        tag = str(dtype)[6:]
        for name, (wrapper, halo) in _MEHR.items():
            kern, plain = _kernel_pair(wrapper, halo)
            with _env(HEAT3D_MEHRSTELLEN="0"):
                chain_ms = _time_ms(lambda: kern(u, taps, False, 0.0, out=out), iters=10)
                _hold(worst, wrapper, out, plain(u, taps, False, 0.0),
                      f"27pt chain at {n}^3 {dtype}")
            with _env(HEAT3D_MEHRSTELLEN="1"):
                ms = _time_ms(lambda: kern(u, taps, False, 0.0, out=out), iters=10)
                _hold(worst, name, out, plain(u, taps, False, 0.0), f"at {n}^3 {dtype}")
                plain_ms = (_time_ms(lambda: plain(u, taps, False, 0.0), iters=3)
                            if dtype == torch.float32 else None)
            b_ms, by = kernel_bound(wrapper, n, halo, u.element_size(),
                                    sd.MEHRSTELLEN_KERNEL_OPS, bw)
            cb_ms, cby = kernel_bound(wrapper, n, halo, u.element_size(),
                                      flops_per_update(taps), bw)
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                   "library_ms": None,
                   "kernel": f"direct_kernel<{'float' if tag == 'float32' else '__nv_bfloat16'},"
                             f"{halo},SPEC_MEHR>",
                   **resources[f"h{halo}_mehrstellen_{tag}"],
                   "chain_27pt": {"ms": chain_ms, "bound_ms": cb_ms, "bound_by": cby,
                                  **resources[f"h{halo}_27pt_{tag}"]},
                   "mehrstellen_over_chain": ms / chain_ms}
            if halo == 1 and dtype == torch.float32:
                with _env(HEAT3D_MEHRSTELLEN="1"):
                    got = kern(u, taps, False, 0.0)
                up = pad_local(u, _bc(False), 0.0)
                w = torch.from_numpy(np.asarray(taps, dtype=np.float32)).cuda()[None, None]
                torch.backends.cudnn.allow_tf32 = False

                def library():
                    return F.conv3d(up[None, None], w)

                row["library_ms"] = _time_ms(library, iters=3)
                row.update(_library_check(name, got, library()[0, 0], taps, u))
                del up, got
            variants[f"{name}_{tag}"] = row
            if dtype == torch.float32:
                res[name] = row
        del u, out
        torch.cuda.empty_cache()
    _say("mehrstellen_times", grid=[n] * 3, stencil="27pt", variants=variants,
         max_abs_err={name: worst[name] for name in _MEHR})
    return res


# Steps of the golden runs in bf16 compute. The bf16 stencil rounds the
# weights and every operation to bf16, which drifts the 7pt hot cube by
# about 0.25% a step against the fp64 oracle: at 20 steps (the fp32
# goldens' count) 7pt reaches 0.0501 relative error, above the 5e-2 gate,
# in the port and in the JAX package alike once XLA rounds every operation
# (``--xla_allow_excess_precision=false``; its default-flag CPU run, 0.0492,
# keeps float32 between operations). ``_bf16_drift`` shows that 20-step
# run; the gated runs take 10 steps.
_BF16_GOLDEN_STEPS = 10
# (stencil, extra flags, time_blocking, storage, env, kernel it must launch)
# of the golden runs in bf16 compute (--compute-dtype bf16), 128^3: the
# direct kernels and streamk (fp32 and bf16 storage), the stream kernel on
# the exchange path, the Mehrstellen instances, and the four fused kernels
# on cuda:0
_GOLDEN_BF16 = tuple(
    ("7pt", [], tb, storage, {}, want)
    for tb, want in ((1, "apply_taps_direct"), (2, "apply_taps_direct2"),
                     (4, "apply_taps_streamk"))
    for storage in ("fp32", "bf16")) + (
    ("7pt", [], 1, "fp32", {"HEAT3D_NO_DIRECT": "1"}, "apply_taps_stream"),
    ("27pt", [], 1, "fp32", {"HEAT3D_MEHRSTELLEN": "1"}, "apply_taps_direct:mehrstellen"),
    ("27pt", [], 2, "fp32", {"HEAT3D_MEHRSTELLEN": "1"}, "apply_taps_direct2:mehrstellen"),
    ("7pt", ["--mesh", "8", "1", "1", "--halo", "dma", "--overlap", "--device", "cuda:0"],
     1, "fp32", {}, "apply_step_fused_dma"),
    ("7pt", ["--mesh", "8", "1", "1", "--halo", "dma", "--overlap", "--device", "cuda:0"],
     2, "fp32", {}, "apply_superstep_fused_dma"),
    ("27pt", ["--mesh", "4", "1", "1", "--fused-rdma", "on", "--halo-plan", "partitioned",
              "--device", "cuda:0"], 1, "bf16", {"HEAT3D_PLAN_PART_MIN_BYTES": "0"},
     "apply_step_fused_rdma"),
    ("27pt", ["--mesh", "4", "1", "1", "--fused-rdma", "on", "--halo-plan", "partitioned",
              "--device", "cuda:0"], 2, "bf16", {"HEAT3D_PLAN_PART_MIN_BYTES": "0"},
     "apply_superstep_fused_rdma"),
)


def _golden_bf16() -> None:
    """The command line at 128^3 with ``--compute-dtype bf16`` and
    ``--golden-check`` (the 5e-2 gate of a chain with bf16 in it): each
    run launches its kernel's bf16-compute instance (``_GOLDEN_BF16``);
    then ``_bf16_drift``."""
    for kind, flags, tb, storage, env, want in _GOLDEN_BF16:
        before = _bf16_counts()[want]
        with _env(**env):
            _golden_cli(["--grid", "128", "--steps", str(_BF16_GOLDEN_STEPS), "--stencil", kind,
                         "--time-blocking", str(tb), "--dtype", storage,
                         "--compute-dtype", "bf16", *flags], want.split(":")[0],
                        stencil=kind, time_blocking=tb, dtype=storage, compute_dtype="bf16",
                        flags=flags, env=env)
        _check(_bf16_counts()[want] > before,
               f"golden bf16 compute {kind} tb={tb} {storage} {flags} {env}: no "
               f"bf16-compute launch of {want}")
    _bf16_drift()


def _bf16_drift() -> None:
    """The 7pt hot cube at 128^3 in bf16 compute (fp32 storage, tb=1), 10
    and 20 steps, against the fp64 oracle: the relative error printed
    beside the 5e-2 gate (not gated: at 20 steps it is the bf16 stencil's
    own drift, see ``_BF16_GOLDEN_STEPS``); gated: the solver's field
    equals, bitwise, the plain per-op bf16 update applied as many times on
    the card (the arithmetic the JAX package computes when XLA rounds every
    operation)."""
    import numpy as np
    import torch

    from heat3d_tpu_torch import eqn
    from heat3d_tpu_torch.core import golden
    from heat3d_tpu_torch.core.config import GridConfig, Precision, SolverConfig
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.ops import stencil_direct as sd

    cfg = SolverConfig(grid=GridConfig.cube(128),
                       precision=Precision(storage="float32", compute="bfloat16"))
    taps = eqn.solver_taps(cfg)
    solver = HeatSolver3D(cfg)
    u = solver.init_state("hot-cube")
    plain = u.clone()
    u0 = golden.make_init("hot-cube", cfg.grid.shape, seed=cfg.run.seed)
    rel, done = {}, 0
    for steps in (10, 20):
        u = solver.run(u, steps - done)
        for _ in range(steps - done):
            plain = sd.apply_taps_direct_ref(plain, taps, False, 0.0, torch.bfloat16)
        done = steps
        torch.cuda.synchronize()
        _check(torch.equal(u, plain), f"bf16 compute solve != plain per-op update at {steps}")
        g = golden.run(u0, cfg.grid, cfg.stencil, steps, taps=taps)
        got = solver.gather(u).astype(np.float64)
        rel[steps] = float(np.max(np.abs(got - g)) / np.max(np.abs(g)))
    _say("bf16_drift", grid=[128] * 3, stencil="7pt", dtype="float32", compute_dtype="bfloat16",
         time_blocking=1, golden_rel_err_by_steps=rel, gate=5e-2,
         golden_pass_by_steps={k: v < 5e-2 for k, v in rel.items()},
         solve_equals_plain_per_op_update=True)


# BASELINE.json config 5 ("bf16 stencil + fp32 residual norm, 4096^3
# strong-scale on v5p-128") cut to one card: 1024^3, every shard on cuda:0
_CONFIG5_CUT = ("BASELINE.json config 5 is 4096^3 over 128 chips; here 1024^3 on one "
                "H100, every shard of a mesh on cuda:0")
# (stencil, storage, time_blocking, mesh, knobs, env) of the full-width rows
# in bf16 compute
_FULL_WIDTH_BF16 = (
    ("7pt", "float32", 2, (1, 1, 1), {}, {}),
    ("7pt", "float32", 4, (1, 1, 1), {}, {}),
    ("7pt", "bfloat16", 2, (1, 1, 1), {}, {}),
    ("27pt", "float32", 2, (1, 1, 1), {}, {"HEAT3D_MEHRSTELLEN": "1"}),
    ("7pt", "float32", 2, (8, 1, 1), {"halo": "dma", "overlap": True}, {}),
    ("7pt", "float32", 1, (4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, {}),
)


def _full_width_bf16(bw: float) -> None:
    """The full-width rows of BASELINE config 5's precision (bf16 stencil,
    fp32 residual) cut to one card (``_CONFIG5_CUT``), each beside its
    bound: the compute dtype moves no bytes, so the bound is the storage
    dtype's (its operations counted at the fp32 rate, below the bytes
    either way). Each row must launch bf16-compute instances."""
    import torch

    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.ops import stencil_direct as sd

    n = 1024
    for kind, storage, tb, mesh, knobs, env in _FULL_WIDTH_BF16:
        with _env(**env):
            cfg = SolverConfig(grid=GridConfig.cube(n), stencil=StencilConfig(kind=kind),
                               precision=Precision(storage=storage, compute="bfloat16"),
                               mesh=MeshConfig(shape=mesh), time_blocking=tb, **knobs)
            before = sum(_bf16_counts().values())
            row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3,
                                   device=None if mesh == (1, 1, 1) else "cuda:0")
            took = sum(_bf16_counts().values()) - before
        route = row["superstep_route"] if tb > 1 else row["step_route"]
        _check(took > 0 and row["compute_dtype"] == "bfloat16",
               f"{route} bf16 compute: {took} bf16-compute launches, row {row}")
        itemsize = torch.empty((), dtype=getattr(torch, storage)).element_size()
        flops = (sd.MEHRSTELLEN_KERNEL_OPS if row.get("mehrstellen_route")
                 else flops_per_update(_taps(kind)))
        if mesh == (1, 1, 1):
            b_ms, by = superstep_bound(route, n, tb, itemsize, flops, bw)
        else:
            b_ms, by, _ = sharded_superstep_bound(route, n, mesh, tb, itemsize, flops, bw)
        _say("full_width", grid=row["grid"], stencil=kind, dtype=storage,
             compute_dtype=row["compute_dtype"], cut=_CONFIG5_CUT, mesh=row["mesh"],
             halo=row["halo"], overlap=row["overlap"], fused_rdma=row["fused_rdma"],
             halo_plan=row["halo_plan"], env=env, time_blocking=tb, route=route,
             mehrstellen_route=row.get("mehrstellen_route"), steps=row["steps"],
             gcell_updates_per_sec=row["gcell_updates_per_sec"],
             ms_per_superstep=row["ms_per_launch"], bound_ms_per_superstep=b_ms,
             bound_by=by, bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
             compute_bf16_launches=took, kernel_launches=row["kernel_launches"],
             seconds_all=row["seconds_all"])
        _BENCH_ROWS.append(dict(row))
        del row
        torch.cuda.empty_cache()


def phase_compute_bf16_times(bw: float, worst: dict, resources: dict) -> dict:
    """Each bf16-compute instance at 1024^3 (Dirichlet bc 0) beside the
    fp32-compute instance of the same chain in the same call, timed in the
    order fp32, bf16, bf16, fp32 (the least of each arm's 20 launches):
    direct1, direct2, the stream kernel and streamk k = 2..4 (7pt, fp32
    storage), direct1/direct2 in bf16 storage, the Mehrstellen instances
    (27pt, fp32 storage), the fused DMA kernels over (8,1,1) and the RDMA
    ones over (4,1,1) (7pt, fp32 storage; the partitioned plan's default
    sub-blocks). Each bf16 launch is held bitwise to its plain version.
    The bound is the fp32 arm's: compute moves no bytes. Returns, per
    kernels-line name, ``{"compute_fp32": ..., "compute_bf16": ...}`` with
    ms, bound, blocks per SM, registers and spills."""
    import torch

    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    n = 1024
    f32, bf = torch.float32, torch.bfloat16
    fields = ("smem_bytes", "blocks_per_sm", "registers", "spill_stores", "spill_loads")
    res = {}

    def ab(run32, runbf):
        a, b = _time_ms(run32, iters=10), _time_ms(runbf, iters=10)
        b = min(b, _time_ms(runbf, iters=10))
        return min(a, _time_ms(run32, iters=10)), b

    def pair(ms32, msbf, b_ms, by, key):
        return {"compute_fp32": {"ms": ms32, "bound_ms": b_ms, "bound_by": by,
                                 **{f: resources[key].get(f) for f in fields}},
                "compute_bf16": {"ms": msbf, "bound_ms": b_ms, "bound_by": by,
                                 **{f: resources[key + BF16C].get(f) for f in fields}},
                "bf16_over_fp32": msbf / ms32, "instance_key": key}

    cases = ([(name if name != "apply_taps_streamk" else f"{name}_k{k}", name, k, "7pt", f32, {})
              for name, k in _cases()]
             + [(f"{name}_bfloat16", name, k, "7pt", bf, {}) for name, k in _cases()[:2]]
             + [(m, w, h, "27pt", f32, {"HEAT3D_MEHRSTELLEN": "1"}) for m, (w, h) in _MEHR.items()])
    base = torch.rand((n, n, n), device="cuda")
    for key, name, k, kind, dtype, env in cases:
        taps = _taps(kind, n)
        u = base.to(dtype)
        with _env(**env):
            k32 = _kernel_pair(name, k)[0]
            kbf, pbf = _kernel_pair(name, k, cd=bf)
            x = _kernel_input(name, u, False, 0.0, k)
            o32, obf = torch.empty_like(u), torch.empty_like(u)
            ms32, msbf = ab(lambda: k32(x, taps, False, 0.0, out=o32),
                            lambda: kbf(x, taps, False, 0.0, out=obf))
            _hold(worst, key if key in _MEHR else name, obf, pbf(x, taps, False, 0.0),
                  f"bf16 compute k={k} at {n}^3 {kind} {dtype} bc=0.0")
            direct = name in ("apply_taps_direct", "apply_taps_direct2")
            code = sd.direct_instance(taps) if direct else ss.stream_instance(taps)
        flops = sd.MEHRSTELLEN_KERNEL_OPS if key in _MEHR else flops_per_update(taps)
        b_ms, by = kernel_bound(name, n, k, u.element_size(), flops, bw)
        res[key] = pair(ms32, msbf, b_ms, by, f"{'h' if direct else 'k'}{k}_"
                                              f"{_instance_name(code)}_{str(dtype)[6:]}")
        del u, x, o32, obf
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    taps = _taps("7pt", n)
    for name, mesh_shape in (("apply_step_fused_dma", (8, 1, 1)),
                             ("apply_superstep_fused_dma", (8, 1, 1)),
                             ("apply_step_fused_rdma", (4, 1, 1)),
                             ("apply_superstep_fused_rdma", (4, 1, 1))):
        k = _FUSED[name][0]
        mesh = _card_mesh(mesh_shape, tuple(n // p for p in mesh_shape))
        us = [torch.rand(mesh.local_shape, device=s.device) for s in mesh.shards]
        o32 = [torch.empty_like(u) for u in us]
        obf = [torch.empty_like(u) for u in us]
        state = _fused_state(mesh, name, f32, False)
        k32 = _fused_pair(name)[0]
        kbf, pbf = _fused_pair(name, cd=bf)

        def go(kern, dst):
            mesh.fork()
            kern(us, taps, mesh, state, False, 0.0, outs=dst)
            mesh.join()

        ms32, msbf = ab(lambda: go(k32, o32), lambda: go(kbf, obf))
        _hold_fused(worst, name, obf, pbf(us, taps, mesh, None, False, 0.0),
                    f"bf16 compute at {n}^3 on {mesh_shape}")
        b_ms, by, _ = fused_bound(n, mesh_shape, k, 4, flops_per_update(taps), bw)
        inst = fd.fused_instance(k, taps)
        res[name] = pair(ms32, msbf, b_ms, by, f"fused_h{k}_{_instance_name(inst)}_float32")
        res[name]["mesh"] = list(mesh_shape)
        res[name]["send_ranges"] = [list(b) for b in state.bounds]
        del us, o32, obf, state
        torch.cuda.empty_cache()
    res["apply_taps_streamk"] = res[f"apply_taps_streamk_k{_STREAMK_HEADLINE}"]
    _say("compute_bf16_times", grid=[n] * 3, bc_value=0.0, times=res, bitwise=True,
         max_abs_err={name: worst[name] for name in COMPUTE_KERNELS})
    return res


def phase_main_path(bw: float) -> dict:
    """Phases 5 and 6 between zeroed and read launch counts; fails unless
    every kernel was launched there, none on a generic instance. Prints the
    1024^3-equivalent launches of every kernel and of its bf16-compute
    instance (the output cells of the bf16 goldens and rows). Returns the
    launch counts."""
    from heat3d_tpu_torch import ops

    def all_cells():
        return {**ops.cell_counts(), **_mehrstellen_counts(cells=True)}

    def bf16_part(run):
        # every stencil launch of the bf16 goldens and rows is a
        # bf16-compute one: their output cells are the bf16 instances'
        before = all_cells()
        run()
        for name, n in all_cells().items():
            bf16_cells[name] = bf16_cells.get(name, 0) + n - before[name]

    ops.reset_launch_counts()
    bf16_cells = {}
    phase_golden()
    _golden_mehrstellen()
    bf16_part(_golden_bf16)
    phase_full_width(bw)
    _full_width_mehrstellen(bw)
    bf16_part(lambda: _full_width_bf16(bw))
    launches = {**ops.launch_counts(), **_mehrstellen_counts()}
    generic = _generic_counts()
    bf16 = _bf16_counts()
    cells = all_cells()
    for name in KERNELS + tuple(_MEHR):
        _check(launches[name] > 0, f"{name} was not launched on the main path")
    for name in COMPUTE_KERNELS:
        _check(bf16[name] > 0, f"{name} launched no bf16-compute instance on the main path")
    _check(not any(generic.values()),
           f"the main path's 7pt/27pt direct, stream or fused launches took the generic "
           f"instance: {generic}")
    unit = {name: _unit_cells(_MEHR[name][0] if name in _MEHR else name)
            for name in KERNELS + tuple(_MEHR)}
    equiv = {name: cells[name] / unit[name] for name in unit}
    _say("main_path", kernel_launches={name: launches[name] for name in KERNELS},
         mehrstellen_instance_launches=_mehrstellen_counts(),
         compute_bf16_instance_launches=bf16,
         generic_instance_launches=generic, output_cells=cells,
         launches_1024_equivalent=equiv, launches_1024_equivalent_unit=unit,
         compute_bf16_launches_1024_equivalent={
             name: bf16_cells[name] / unit[name] for name in COMPUTE_KERNELS})
    return launches


# the families phase's rows at 1024^3 fp32, every shard on cuda:0: (equation,
# eq_params, stencil, time_blocking, mesh, the kernel the route launches,
# the solver's route knobs)
_OVERLAP_DMA = (("halo", "dma"), ("overlap", True))
_FAMILY_ROWS = (
    ("aniso-diffusion", (), "7pt", 2, (1, 1, 1), "apply_taps_direct2", ()),
    ("aniso-diffusion", (), "7pt", 1, (1, 1, 1), "apply_taps_direct", ()),
    ("advection-diffusion", (("vx", 2.0),), "7pt", 1, (1, 1, 1), "apply_taps_direct", ()),
    ("advection-diffusion", (("vx", 2.0),), "7pt", 1, _MESH, "apply_taps_direct", ()),
    ("advection-diffusion", (("vx", 2.0),), "7pt", 2, (1, 1, 1), "apply_taps_direct2", ()),
    ("advection-diffusion", (("vx", 2.0),), "7pt", 4, (1, 1, 1), "apply_taps_streamk", ()),
    ("advection-diffusion", (("vx", 2.0),), "7pt", 2, (8, 1, 1), "apply_superstep_fused_dma",
     _OVERLAP_DMA),
    ("reaction-diffusion", (("rate", 0.5),), "27pt", 2, (1, 1, 1), "apply_taps_direct2", ()),
    ("reaction-diffusion", (("rate", 0.5),), "7pt", 4, (1, 1, 1), "apply_taps_streamk", ()),
)
_FAMILY_KERNELS = ("apply_taps_direct", "apply_taps_direct2", "apply_taps_streamk")


def _family_cfg(n, equation, params, kind, tb, mesh=(1, 1, 1), periodic=False, bcv=0.0,
                knobs=()):
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, SolverConfig, StencilConfig,
    )

    return SolverConfig(grid=GridConfig.cube(n),
                        stencil=StencilConfig(kind=kind, bc=_bc(periodic), bc_value=bcv),
                        mesh=MeshConfig(shape=mesh), time_blocking=tb, equation=equation,
                        eq_params=params, **dict(knobs))


def _knob_argv(knobs) -> list:
    """The command line's flags of the solver's route knobs."""
    argv = []
    for name, value in knobs:
        argv += [f"--{name.replace('_', '-')}"] + ([] if value is True else [str(value)])
    return argv


def _eq_argv(equation, params):
    argv = ["--equation", equation]
    for name, value in params:
        argv += ["--eq-param", f"{name}={value}"]
    return argv


def _device_random(shape, seed: int, dev="cuda:0"):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)


def _hold_families(worst: dict, n: int) -> int:
    """Each family row's kernel on the first superstep's input (a random
    n^3 field; the (2,2,2) row: each of its shards) bitwise against its
    plain version, on the instance ``stream_instance`` names, for each
    boundary setting; and the (2,2,2) faces-direct step of the asymmetric
    advection taps (kernel and shell patches) bitwise against the (1,1,1)
    step. Returns the number of kernel cases."""
    import torch

    from heat3d_tpu_torch import eqn
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    cases = 0
    u = _device_random((n, n, n), 12)
    for equation, params, kind, tb, mesh, name, _ in _FAMILY_ROWS:
        taps = eqn.solver_taps(_family_cfg(n, equation, params, kind, tb))
        if name in _FUSED:
            cases += _hold_family_fused(worst, name, u, taps, mesh)
            continue
        blocks = [u] if mesh == (1, 1, 1) else _split(u, _card_mesh(mesh, (n // 2,) * 3))
        for periodic, bcv in _BCS:
            for i, x in enumerate(blocks):
                _hold_instance(worst, name, x, taps, periodic, bcv, tb,
                               f"{equation} {dict(params)} {kind} tb={tb} block {i} of "
                               f"{mesh} periodic={periodic} bc={bcv}")
                cases += 1
        torch.cuda.empty_cache()
        if mesh != (1, 1, 1):
            outs = []
            for m, dev in (((1, 1, 1), None), (mesh, "cuda:0")):
                cfg = _family_cfg(n, equation, params, kind, tb, m, bcv=0.3)
                solver = HeatSolver3D(cfg, device=dev)
                state = solver.init_state("hot-cube")
                us = _shard_list(state)
                for t, x in zip(us, [u] if m == (1, 1, 1) else _split(u, solver.mesh)):
                    t.copy_(x)
                outs.append(_shard_list(solver.step(state)))
                del solver, state, us
            single, shards = outs
            sm = _card_mesh(mesh, (n // 2,) * 3)
            for s, got in zip(sm.shards, shards):
                want = single[0][tuple(slice(o, o + n // 2) for o in s.origin)]
                _check(torch.equal(got, want),
                       f"{equation} {mesh} faces-direct step != (1,1,1) step at shard "
                       f"{s.coords}: max err {float((got - want).abs().max())}")
            del outs, single, shards
            torch.cuda.empty_cache()
    del u
    torch.cuda.empty_cache()
    return cases


def _hold_family_fused(worst: dict, name: str, u, taps, mesh_shape) -> int:
    """Fused kernel ``name`` (the family row's) over ``u`` split on
    ``mesh_shape``, one launch over every shard for Dirichlet 0.3 and
    periodic, bitwise against its plain version, each launch counted on the
    generic instance where ``stream_instance`` names it. Returns the number
    of cases."""
    from heat3d_tpu_torch.ops import stencil_stream as ss

    mesh = _card_mesh(mesh_shape, tuple(g // p for g, p in zip(u.shape, mesh_shape)))
    us = _split(u, mesh)
    kern, plain = _fused_pair(name)
    generic = ss.stream_instance(taps) == ss.GENERIC
    for periodic, bcv in ((False, 0.3), (True, 0.0)):
        state = _fused_state(mesh, name, u.dtype, periodic)
        before = _generic_counts()[name]
        got = kern(us, taps, mesh, state, periodic, bcv)
        _hold_fused(worst, name, got, plain(us, taps, mesh, None, periodic, bcv),
                    f"family row on {mesh_shape} periodic={periodic} bc={bcv}")
        _check(_generic_counts()[name] - before == generic,
               f"{name} family row: generic launches {_generic_counts()[name] - before}")
        del got, state
    return 2


def phase_families(bw: float, worst: dict, n: int = 1024, golden_n: int = 128) -> dict:
    """The explicit equation families at full width through the kernels:
    ``_hold_families``, then with the launch counts zeroed each row of
    ``_FAMILY_ROWS`` through ``bench_throughput`` (Gcell/s, ms per
    superstep beside its bound, the instance each launch took) and each
    family golden-checked at 128^3 through the command line; fails unless
    each of the direct, direct2 and streamk kernels launched there."""
    import torch

    from heat3d_tpu_torch import eqn, ops
    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.ops import stencil_stream as ss

    t0 = time.perf_counter()
    cases = _hold_families(worst, n)
    ops.reset_launch_counts()
    for equation, params, kind, tb, mesh, name, knobs in _FAMILY_ROWS:
        cfg = _family_cfg(n, equation, params, kind, tb, mesh, knobs=knobs)
        taps = eqn.solver_taps(cfg)
        code = ss.stream_instance(taps)
        before = _generic_counts()[name]
        row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3,
                               device=None if mesh == (1, 1, 1) else "cuda:0")
        generic = _generic_counts()[name] - before
        launches = row["kernel_launches"][name]
        route = row["superstep_route"] if tb > 1 else row["step_route"]
        flops = flops_per_update(taps)
        if mesh == (1, 1, 1):
            b_ms, by = superstep_bound(route, n, tb, 4, flops, bw)
            passes = "exchange" if route == "streamk" else None
        else:
            b_ms, by, _ = sharded_superstep_bound(route, n, mesh, tb, 4, flops, bw)
            passes = "fused" if route.startswith("fused") else "faces"
        _check(launches > 0 and generic == (launches if code == ss.GENERIC else 0),
               f"{equation} {kind} tb={tb}: {launches} {name} launches, {generic} generic "
               f"(instance {_instance_name(code)}): {row}")
        _say("families", equation=equation, eq_params=dict(params), stencil=kind,
             grid=row["grid"], mesh=row["mesh"], time_blocking=tb, route=route,
             chain_ops=row["chain_ops"], steps=row["steps"],
             gcell_updates_per_sec=row["gcell_updates_per_sec"],
             ms_per_superstep=row["ms_per_launch"], bound_ms_per_superstep=b_ms,
             bound_by=by, bound_passes=_BOUND_PASSES.get(passes),
             bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
             instance=_instance_name(code), kernel=name, launches=launches,
             generic_launches=generic, seconds_all=row["seconds_all"])
        _BENCH_ROWS.append(dict(row))
        del row
        torch.cuda.empty_cache()
    for equation, params, kind, tb, mesh, name, knobs in _FAMILY_ROWS:
        _golden_cli(["--grid", str(golden_n), "--steps", "20", "--stencil", kind,
                     "--time-blocking",
                     str(tb), *_eq_argv(equation, params), "--mesh", *map(str, mesh),
                     *_knob_argv(knobs), "--device", "cuda:0"],
                    name, equation=equation, eq_params=dict(params), stencil=kind,
                    mesh=list(mesh), time_blocking=tb, gate=1e-5)
    launches = ops.launch_counts()
    for name in _FAMILY_KERNELS:
        _check(launches[name] > 0, f"{name} was not launched on the families path")
    _say("families_path", kernel_launches=launches, generic_instance_launches=_generic_counts(),
         kernel_cases_bitwise=cases, max_abs_err={k: worst[k] for k in _FAMILY_KERNELS},
         seconds=time.perf_counter() - t0)
    return launches


# the integrators phase: (stencil, time_blocking) of the leapfrog checks
_LEAPFROG_ROWS = (("7pt", 1), ("27pt", 1), ("7pt", 2))
# the fp64 references' gates: leapfrog (relative to the field's largest
# value, 10 steps), CG (absolute, a field in [0, 1])
_LEAPFROG_GATE = 1e-5
_CG_GATE = 5e-5
# the CG full-width cubes, tried in order until one fits the card
_CG_CUBES = (1024, 896, 768, 640, 512)


def _wave_cfg(n, kind, tb, mesh=(1, 1, 1), bcv=0.3):
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, SolverConfig, StencilConfig,
    )

    return SolverConfig(grid=GridConfig.cube(n),
                        stencil=StencilConfig(kind=kind, bc=_bc(False), bc_value=bcv),
                        mesh=MeshConfig(shape=mesh), time_blocking=tb, equation="wave",
                        integrator="leapfrog")


def _cg_cfg(n, mesh=(1, 1, 1), bcv=0.3):
    """Heat 7pt under implicit-CG at 4x the explicit bound's dt."""
    import dataclasses

    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, SolverConfig, StencilConfig,
    )

    grid = GridConfig.cube(n)
    return SolverConfig(grid=dataclasses.replace(grid, dt=4.0 * grid.stable_dt()),
                        stencil=StencilConfig(kind="7pt", bc=_bc(False), bc_value=bcv),
                        mesh=MeshConfig(shape=mesh), integrator="implicit-cg")


def _leapfrog_checks(n: int = 128) -> list:
    """At 128^3 over (1,1,1) and (2,2,2) on cuda:0, 10 steps from random
    levels: the sharded run bitwise equal to the (1,1,1) run, and both
    levels held to ``leapfrog.reference_step`` (fp64)."""
    import numpy as np

    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.timeint import leapfrog

    steps, bcv = 10, 0.3
    rng = np.random.default_rng(21)
    u0, um1 = (rng.standard_normal((n, n, n)).astype(np.float32) for _ in range(2))
    refs, out = {}, []
    for kind, tb in _LEAPFROG_ROWS:
        got = []
        for mesh, dev in (((1, 1, 1), None), (_MESH, "cuda:0")):
            solver = HeatSolver3D(_wave_cfg(n, kind, tb, mesh, bcv), device=dev)
            c = solver.run(solver.init_state((u0, um1)), steps)
            got.append((solver.gather(c[0]), solver.gather(c[1])))
        for level in (0, 1):
            _check(got[0][level].tobytes() == got[1][level].tobytes(),
                   f"leapfrog {kind} tb={tb}: (2,2,2) level {level} != (1,1,1): max err "
                   f"{float(np.abs(got[0][level] - got[1][level]).max())}")
        if kind not in refs:
            taps = leapfrog.leapfrog_taps(_wave_cfg(n, kind, 1))
            u, up = u0, um1
            for _ in range(steps):
                u, up = leapfrog.reference_step(u, up, taps, periodic=False, bc_value=bcv), u
            refs[kind] = (u, up)
        rel = [float(np.abs(got[0][level] - refs[kind][level]).max()
                     / np.abs(refs[kind][level]).max()) for level in (0, 1)]
        _check(max(rel) < _LEAPFROG_GATE,
               f"leapfrog {kind} tb={tb} vs fp64 reference: rel err {rel}")
        row = dict(stencil=kind, time_blocking=tb, grid=[n] * 3, steps=steps,
                   meshes=[[1, 1, 1], list(_MESH)], sharded_bitwise=True,
                   rel_err_vs_fp64=rel, gate=_LEAPFROG_GATE)
        _say("integrators", integrator="leapfrog", equation="wave", **row)
        out.append(row)
    return out


def _cg_checks(n: int = 128) -> list:
    """At 128^3, two backward-Euler steps at 4x the explicit dt over (1,1,1)
    and (2,2,1) on cuda:0: each held to ``cg.reference_solve`` (fp64), the
    sharded one to the (1,1,1) one (the field within 1e-5 of its largest
    value, iterations within one), with ``last_cg_stats``."""
    import numpy as np

    from heat3d_tpu_torch import eqn
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.timeint import cg

    steps, bcv = 2, 0.3
    u0 = np.random.default_rng(22).uniform(0.0, 1.0, (n, n, n)).astype(np.float32)
    taps = eqn.solver_taps(_cg_cfg(n))
    want = u0
    for _ in range(steps):
        want = cg.reference_solve(want, taps, periodic=False, bc_value=bcv)
    got, out = [], []
    for mesh, dev in (((1, 1, 1), None), ((2, 2, 1), "cuda:0")):
        solver = HeatSolver3D(_cg_cfg(n, mesh, bcv), device=dev)
        u = solver.gather(solver.run(solver.init_state(u0), steps))
        err = float(np.abs(u - want).max())
        _check(err < _CG_GATE, f"implicit-cg {mesh} vs fp64 reference: max err {err}")
        got.append((u, solver.last_cg_stats))
        row = dict(mesh=list(mesh), grid=[n] * 3, steps=steps,
                   dt_over_explicit_bound=4.0, cg_iters=solver.last_cg_stats[0],
                   cg_relres=solver.last_cg_stats[1], max_abs_err_vs_fp64=err, gate=_CG_GATE)
        _say("integrators", integrator="implicit-cg", equation="heat", stencil="7pt", **row)
        out.append(row)
    (a, sa), (b, sb) = got
    diff = float(np.abs(a - b).max())
    _check(diff <= 1e-5 * float(np.abs(a).max()) and abs(sa[0] - sb[0]) <= 1,
           f"implicit-cg (2,2,1) vs (1,1,1): max diff {diff}, stats {sa} vs {sb}")
    return out


def _full_width_integrators(bw: float, cubes=_CG_CUBES) -> list:
    """A few steps of each integrator at full width on cuda:0: leapfrog 7pt
    tb 1 and 2 at 1024^3 through ``bench_throughput``, and implicit-CG 7pt
    at 4x the explicit dt at the largest cube of ``_CG_CUBES`` that fits,
    each with its ms a step and the peak of allocated device memory."""
    import torch

    from heat3d_tpu_torch.bench.harness import bench_throughput, throughput_row
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.ops.stencil_direct import chain_ops
    from heat3d_tpu_torch.timeint import cg, leapfrog
    from heat3d_tpu_torch.utils.timing import cuda_time, sync_rtt

    out = []
    n = cubes[0]
    for tb in (1, 2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = _wave_cfg(n, "7pt", tb, bcv=0.0)
        row = bench_throughput(cfg, steps=2 * tb, warmup=1, repeats=2)
        # per update: read u and write its width-1 block, read the block and
        # u_prev, write u_new (5 field passes); the chain and the subtraction
        flops = chain_ops(leapfrog.leapfrog_taps(cfg)) + 1
        b_ms, by = bound_ms(5 * n**3 * 4, n**3 * flops, bw)
        r = dict(integrator="leapfrog", equation="wave", stencil="7pt", grid=[n] * 3,
                 time_blocking=tb, route=row["superstep_route"] or row["step_route"],
                 backend=row["backend"], steps=row["steps"],
                 gcell_updates_per_sec=row["gcell_updates_per_sec"],
                 ms_per_step=row["seconds_best"] / row["steps"] * 1e3,
                 bound_ms_per_step=b_ms, bound_by=by,
                 bound_passes="read u, write the width-1 block, read it and u_prev, "
                              "write u_new (5 field passes per update)",
                 max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                 kernel_launches=row["kernel_launches"], seconds_all=row["seconds_all"])
        _say("integrators_full_width", **r)
        out.append(r)
        del row
    max_iters, _ = cg.cg_settings()
    for m in cubes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = _cg_cfg(m, bcv=0.0)
        try:
            solver = HeatSolver3D(cfg)
            u = solver.run(solver.init_state("hot-cube"), 1)
            torch.cuda.synchronize()
            times = []
            for _ in range(2):
                def go():
                    nonlocal u
                    u = solver.run(u, 1)

                times.append(cuda_time(go))
        except torch.cuda.OutOfMemoryError as e:
            reason = f"{m}^3 does not fit: {str(e).splitlines()[0]}"
            _say("integrators_full_width", integrator="implicit-cg", grid=[m] * 3, ran=False,
                 reason=reason)
            solver = u = None
            continue
        row = throughput_row(cfg, steps=1, steps_requested=1, times=times,
                             devices=[torch.device("cuda", 0)], shards=1,
                             sync_rtt_s=sync_rtt(torch.device("cuda", 0)),
                             kernel_launches={})
        r = dict(integrator="implicit-cg", equation="heat", stencil="7pt", grid=[m] * 3,
                 ran=True, reduced_from=None if m == n else [n] * 3,
                 reason=None if m == n else f"{n}^3 did not fit the card",
                 dt_over_explicit_bound=4.0, backend=row["backend"],
                 ms_per_step=min(times) * 1e3, cg_trips_per_step=max_iters,
                 ms_per_trip=min(times) * 1e3 / max_iters,
                 cg_iters=solver.last_cg_stats[0], cg_relres=solver.last_cg_stats[1],
                 gcell_updates_per_sec=row["gcell_updates_per_sec"],
                 max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                 seconds_all=times)
        _say("integrators_full_width", **r)
        out.append(r)
        del solver, u
        torch.cuda.empty_cache()
        break
    return out


def phase_integrators(bw: float, n: int = 128, cubes=_CG_CUBES) -> dict:
    """The leapfrog and implicit-CG integrators on the card, with the launch
    counts zeroed before and read after: they run the plain chain over the
    ppermute exchange (``timeint.pin_config``, the JAX package's choice), so
    the phase fails if any kernel launched."""
    from heat3d_tpu_torch import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    leap = _leapfrog_checks(n)
    cgs = _cg_checks(n)
    full = _full_width_integrators(bw, cubes)
    launches = ops.launch_counts()
    _check(not any(launches.values()),
           f"the integrators' path launched a kernel (they run the plain chain): {launches}")
    _say("integrators_path", kernel_launches=launches, leapfrog_checks=len(leap),
         cg_checks=len(cgs), full_width_rows=len(full), seconds=time.perf_counter() - t0)
    return launches


# the state phase: the grids of its parts, its fast heal policy's delays and
# its disk budget. Disk: part 1's 1024^3 fp32 checkpoint (4 GiB) is removed
# before part 3, whose 512^3 fp32 runs keep at most three generations each
# (0.5 GiB apiece) for a clean and a faulted run at once (3 GiB); 1 GiB of
# margin for the file system.
_STATE_FULL = 1024
_STATE_N = 512
_STATE_CLI_N = 256
_STATE_VTK_N = 128
_STATE_DISK = (4 << 30) + (1 << 30)
_STATE_WATCHDOG_S = 3.0
# (fault spec, extra run_supervised knobs, config) of part 3's faulted runs
_STATE_FAULTS = (
    ("backend-loss:step=6:down=1", {"probe": None}, "tb2"),
    ("hang:step=6", {"watchdog_s": _STATE_WATCHDOG_S}, "tb2"),
    ("corrupt-shard:save=2,backend-loss:step=8", {}, "tb2"),
    ("partial-device-loss:step=6:keep=4", {"heal_mode": "elastic"}, "dma"),
)


def _state_cfg(n, tb=2, mesh=(1, 1, 1), storage="float32", halo="ppermute"):
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig,
    )

    return SolverConfig(grid=GridConfig.cube(n), mesh=MeshConfig(shape=mesh),
                        precision=Precision(storage=storage), time_blocking=tb, halo=halo)


def _same(a, b) -> bool:
    """Bitwise equality of two states (tensors, ShardedFields or level
    pairs), on the device."""
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    xs, ys = _shard_list(a), _shard_list(b)
    return len(xs) == len(ys) and all(
        torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                    y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
        for x, y in zip(xs, ys))


def _io_rates(stats: dict, seconds: float, parts) -> dict:
    """Seconds, GB/s and each part's share of a save or load."""
    return {"seconds": seconds, "bytes": stats["bytes"],
            "gb_per_s": stats["bytes"] / seconds / 1e9,
            **{f"{p}_share": stats.get(f"{p}_s", 0.0) / seconds for p in parts}}


def _state_resume(root: str, card: str) -> dict:
    """Part 1: 1024^3 fp32 7pt tb=2 on cuda:0, 20 steps uninterrupted against
    10 steps, ``save_checkpoint``, a fresh solver's ``load_checkpoint`` and
    10 more steps: bitwise, with direct2 launched; the save's and load's
    seconds, GB/s and shares."""
    import torch

    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    cfg = _state_cfg(_STATE_FULL)
    path = os.path.join(root, "full")
    before = ops.launch_counts()
    ref_solver = HeatSolver3D(cfg, device="cuda:0")
    ref = ref_solver.run(ref_solver.init_state("hot-cube"), 20)
    first = HeatSolver3D(cfg, device="cuda:0")
    u = first.run(first.init_state("hot-cube"), 10)
    save_stats, load_stats = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first.save_checkpoint(path, u, 10, stats=save_stats)
    save_s = time.perf_counter() - t0
    del first, u
    torch.cuda.empty_cache()
    second = HeatSolver3D(cfg, device="cuda:0")
    t0 = time.perf_counter()
    u, step = second.load_checkpoint(path, stats=load_stats)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    u = second.run(u, 10)
    torch.cuda.synchronize()
    direct2 = ops.launch_counts()["apply_taps_direct2"] - before["apply_taps_direct2"]
    _check(step == 10 and _same(u, ref),
           f"{_STATE_FULL}^3 tb=2 resume from step {step} differs from the 20-step run")
    _check(direct2 > 0, "the 1024^3 resume launched no direct2")
    res = {"grid": [_STATE_FULL] * 3, "time_blocking": 2, "bitwise": True,
           "direct2_launches": direct2,
           "save": _io_rates(save_stats, save_s, ("d2h", "crc", "write")),
           "load": _io_rates(load_stats, load_s, ("read", "crc", "h2d"))}
    _say("state_resume", card=card, **res)
    del ref_solver, ref, second, u
    torch.cuda.empty_cache()
    shutil.rmtree(path)
    return res


def _state_cross(root: str, card: str) -> list:
    """Part 2 at 512^3 on cuda:0: a (2,2,2) faces-direct tb=2 save resumed on
    (1,1,1) for 4 more steps against the uninterrupted (1,1,1) run; a bf16
    save/load round trip; leapfrog's two-level carry saved, resumed and
    stepped against the uninterrupted run; each bitwise."""
    import torch

    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    n, out = _STATE_N, []

    def resume(name, save_cfg, load_cfg, init, steps):
        saver = HeatSolver3D(save_cfg, device="cuda:0")
        u = saver.run(saver.init_state(init), steps)
        path = os.path.join(root, name)
        stats = {}
        t0 = time.perf_counter()
        saver.save_checkpoint(path, u, steps, stats=stats)
        save_s = time.perf_counter() - t0
        loader = HeatSolver3D(load_cfg, device="cuda:0")
        t0 = time.perf_counter()
        got, step = loader.load_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        _check(step == steps, f"{name}: loaded step {step}")
        return saver, u, loader, got, path, {"save_s": save_s, "load_s": load_s,
                                             "bytes": stats["bytes"]}

    # cross-mesh: (2,2,2) saves, (1,1,1) resumes
    one = _state_cfg(n)
    saver, u, loader, got, path, io_ = resume(
        "cross", _state_cfg(n, mesh=(2, 2, 2)), one, "hot-cube", 4)
    ref_solver = HeatSolver3D(one, device="cuda:0")
    ref = ref_solver.run(ref_solver.init_state("hot-cube"), 8)
    _check(_same(loader.run(got, 4), ref), "(2,2,2) save resumed on (1,1,1) differs")
    out.append({"case": "cross-mesh (2,2,2) -> (1,1,1)", **io_})
    del saver, u, loader, got, ref_solver, ref
    shutil.rmtree(path)
    # bf16 storage round trip
    bf = _state_cfg(n, storage="bfloat16")
    saver, u, loader, got, path, io_ = resume("bf16", bf, bf, "hot-cube", 4)
    _check(_same(got, u), "bf16 save/load round trip differs")
    out.append({"case": "bf16 round trip", **io_})
    del saver, u, loader, got
    shutil.rmtree(path)
    # leapfrog's (u, u_prev): save at 4, resume for 4, against 8 straight
    wave = _wave_cfg(n, "7pt", 1)
    saver, u, loader, got, path, io_ = resume("leapfrog", wave, wave, "gaussian", 4)
    _check(_same(got, u) and os.path.isdir(os.path.join(path, "level-1")),
           "leapfrog levels differ after the round trip")
    ref_solver = HeatSolver3D(wave, device="cuda:0")
    ref = ref_solver.run(ref_solver.init_state("gaussian"), 8)
    _check(_same(loader.run(got, 4), ref), "leapfrog resume differs from the 8-step run")
    out.append({"case": "leapfrog two-level resume", **io_})
    del saver, u, loader, got, ref_solver, ref
    shutil.rmtree(path)
    torch.cuda.empty_cache()
    for r in out:
        _say("state_cross", card=card, grid=[n] * 3, bitwise=True, **r)
    return out


def _state_supervised(root: str, card: str) -> list:
    """Part 3: supervised 512^3 (2,2,2) runs on cuda:0, 12 steps,
    checkpoint_every 4, one per ``_STATE_FAULTS`` entry, each bitwise equal
    to the clean supervised run of its config (faces-direct tb=2, or
    ``halo='dma'`` tb=1 for the elastic run, whose stream and DMA launches
    are counted); each recovery record printed."""
    import numpy as np
    import torch

    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.resilience.faults import FaultPlan, _parse_spec
    from heat3d_tpu_torch.resilience.retry import RetryPolicy

    # sub-second probe delays (the default probes every 60 s); the deadline
    # covers a real probe child's start on the card
    fast = RetryPolicy(base_delay_s=0.05, multiplier=1.5, max_delay_s=0.2, deadline_s=120.0)
    cfgs = {"tb2": _state_cfg(_STATE_N, mesh=(2, 2, 2)),
            "dma": _state_cfg(_STATE_N, tb=1, mesh=(2, 2, 2), halo="dma")}

    def supervise(cfg, name, faults, **kw):
        kw.setdefault("probe", lambda: "cuda")
        t0 = time.perf_counter()
        res = HeatSolver3D(cfg, device="cuda:0").run_supervised(
            12, os.path.join(root, name), checkpoint_every=4, heal_policy=fast,
            faults=FaultPlan(_parse_spec(faults) if faults else None), **kw)
        return res, time.perf_counter() - t0

    out = []
    for key, cfg in cfgs.items():
        clean, clean_s = supervise(cfg, f"clean-{key}", "")
        _check(clean.steps_done == 12 and not clean.recoveries, f"clean {key}: {clean}")
        for spec, kw, which in _STATE_FAULTS:
            if which != key:
                continue
            before = ops.launch_counts()
            res, seconds = supervise(cfg, "faulted", spec, **kw)
            after = ops.launch_counts()
            launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            _check(res.steps_done == 12 and len(res.recoveries) == 1,
                   f"{spec}: {res.to_record()}")
            # a survivor mesh holds other shards: compared as gathered fields
            same = (_same(res.u, clean.u) if res.mesh_shape == clean.mesh_shape
                    else np.array_equal(res.solver.gather(res.u),
                                        clean.solver.gather(clean.u)))
            _check(same, f"{spec}: result differs from the clean run")
            rec = res.recoveries[0].to_record()
            if spec.startswith("corrupt-shard"):
                _check(rec["resumed_from"] == 4 and len(rec["quarantined"]) == 1,
                       f"{spec}: no fallback past the corrupt generation: {rec}")
            if spec.startswith("partial"):
                _check(res.degraded and res.mesh_shape == (4, 1, 1)
                       and all(s.device == torch.device("cuda", 0)
                               for s in res.solver.mesh.shards),
                       f"{spec}: survivor mesh {res.mesh_shape}")
                _check(launches.get("apply_taps_stream", 0) > 0
                       and launches.get("halo_dma", 0) > 0,
                       f"{spec}: the dma run launched {launches}")
            row = {"fault": spec, "config": key, "bitwise": True, "recovery": rec,
                   "seconds": seconds, "clean_seconds": clean_s,
                   "survivor_mesh": list(res.mesh_shape), "kernel_launches": launches}
            _say("state_supervised", card=card, grid=[_STATE_N] * 3, mesh=[2, 2, 2], **row)
            out.append(row)
            del res
            shutil.rmtree(os.path.join(root, "faulted"))
        del clean
        shutil.rmtree(os.path.join(root, f"clean-{key}"))
        torch.cuda.empty_cache()
    return out


def _state_cli(root: str, card: str) -> dict:
    """Part 4: the supervised command line at 256^3, killed by an injected
    SIGTERM at step 4 (exit 3), relaunched (exit 0): its final generation's
    shard byte-equal to a clean run's."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    for k in ("HEAT3D_FAULTS", "HEAT3D_FAULT_STATE", "HEAT3D_HEAL_MODE"):
        env.pop(k, None)

    def run(ck, faults=None):
        e = dict(env, **({"HEAT3D_FAULTS": faults,
                          "HEAT3D_FAULT_STATE": os.path.join(root, "fstate")}
                         if faults else {}))
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "heat3d_tpu_torch", "--grid", str(_STATE_CLI_N),
             "--steps", "8", "--checkpoint", os.path.join(root, ck), "--checkpoint-every",
             "2", "--supervise"], env=e, capture_output=True, text=True, timeout=300,
            cwd=here)
        return p, time.perf_counter() - t0

    clean, clean_s = run("cli-clean")
    _check(clean.returncode == 0, f"clean supervised CLI exited {clean.returncode}: "
                                  f"{clean.stderr[-2000:]}")
    killed, killed_s = run("cli-kill", "sigterm:step=4")
    _check(killed.returncode == 3, f"SIGTERM'd CLI exited {killed.returncode}: "
                                   f"{killed.stderr[-2000:]}")
    relaunch, relaunch_s = run("cli-kill", "sigterm:step=4")
    _check(relaunch.returncode == 0, f"relaunched CLI exited {relaunch.returncode}: "
                                     f"{relaunch.stderr[-2000:]}")
    summary = json.loads(relaunch.stdout.strip().splitlines()[-1])
    same = {}
    for name in ("shard_0_0_0.npy", "shard_0_0_0.npy.crc32"):
        with open(os.path.join(root, "cli-clean", "gen-00000008", name), "rb") as a, \
                open(os.path.join(root, "cli-kill", "gen-00000008", name), "rb") as b:
            same[name] = a.read() == b.read()
    _check(all(same.values()), f"relaunched run's gen-00000008 differs: {same}")
    res = {"grid": [_STATE_CLI_N] * 3, "killed_rc": killed.returncode,
           "relaunch_rc": relaunch.returncode, "byte_equal": True,
           "resumed_from": summary["supervised"]["resumed_from"],
           "platform": summary["platform"], "seconds": {
               "clean": clean_s, "killed": killed_s, "relaunch": relaunch_s}}
    _check(summary["platform"] == "gpu", f"the relaunch ran on {summary['platform']}")
    _say("state_cli", card=card, **res)
    return res


def _state_vtk_probe(root: str, card: str) -> dict:
    """Part 5: ``--dump-vtk`` at 128^3 read back with
    ``read_structured_points``, equal to ``gather`` of the same solve; the
    probe child's answer on the card and its seconds."""
    from heat3d_tpu_torch import cli
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.utils import backendprobe, vtkio

    import numpy as np

    path = os.path.join(root, "u.vtk")
    n = _STATE_VTK_N
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--grid", str(n), "--steps", "10", "--mesh", "1", "1", "1",
                       "--dump-vtk", path])
    _check(rc == 0, f"--dump-vtk run exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    field, meta = vtkio.read_structured_points(path)
    s = HeatSolver3D(_state_cfg(n, tb=1), device="cuda:0")
    want = s.gather(s.run(s.init_state("hot-cube"), 10))
    _check(summary["vtk_path"] == path and np.array_equal(field, want),
           "the VTK dump differs from gather")
    t0 = time.perf_counter()
    platform = backendprobe.probe_platform()
    probe_s = time.perf_counter() - t0
    _check(platform == "cuda", f"the probe child found {platform!r} on the card")
    res = {"vtk_grid": list(meta["dimensions"]), "vtk_equal_gather": True,
           "probe_platform": platform, "probe_seconds": probe_s}
    _say("state_vtk_probe", card=card, **res)
    return res


def phase_state(smi: str) -> dict:
    """State and resilience on the card (the checkpoint format, the
    supervisor, the supervised command line, the VTK dump, the probe
    child), in a temporary directory removed at the end; fails without
    ``_STATE_DISK`` bytes free there. Every line carries the card's name
    and power limit: the numbers are host and disk figures of this
    machine."""
    import tempfile

    from heat3d_tpu_torch import ops

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="heat3d_state_")
    try:
        free = shutil.disk_usage(root).free
        _check(free >= _STATE_DISK,
               f"the state phase needs {_STATE_DISK} bytes free in {root}, has {free}")
        before = ops.launch_counts()
        res = {"resume": _state_resume(root, smi), "cross": _state_cross(root, smi),
               "supervised": _state_supervised(root, smi), "cli": _state_cli(root, smi),
               "vtk_probe": _state_vtk_probe(root, smi)}
        after = ops.launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: after[k] - before[k] for k in after}
    _say("state_path", card=smi, kernel_launches=launches, disk_free=free,
         seconds=time.perf_counter() - t0)
    return res


# the obs phase's runs of the command line, every shard on cuda:0: (tag,
# grid, mesh, time_blocking, steps, extra flags); the headline first, then
# the host-bound sharded rows of PERF.md section 5 (1024^3: 512^3 shards)
# and the same meshes at 512^3
_OBS_RUNS = (
    ("headline", 1024, (1, 1, 1), 2, 20, ()),
    ("faces-direct", 1024, (2, 2, 2), 1, 10, ()),
    ("fused-dma-3d", 1024, (2, 2, 2), 1, 10, ("--halo", "dma", "--overlap")),
    ("faces-direct-512", 512, (2, 2, 2), 1, 10, ()),
    ("fused-dma-3d-512", 512, (2, 2, 2), 1, 10, ("--halo", "dma", "--overlap")),
)
# the name each wrapper's CUDA kernel has in a profiler trace (fp32 storage)
_TRACE_NAMES = {
    "apply_taps_direct": "direct_kernel<float, 1,",
    "apply_taps_direct2": "direct_kernel<float, 2,",
    "apply_taps_stream": "stream_kernel<float, 1,",
    "apply_taps_streamk": "stream_kernel<float, ",
    "halo_dma": "halo_push_kernel",
    "apply_step_fused_dma": "fused_chain_kernel<float, 1,",
    "apply_superstep_fused_dma": "fused_chain_kernel<float, 2,",
    "apply_step_fused_rdma": "fused_chain_kernel<float, 1,",
    "apply_superstep_fused_rdma": "fused_chain_kernel<float, 2,",
}
_OBS_PHASE_SHARE = 0.95  # least device share under a heat3d.* phase (headline)
_OBS_STENCIL_TOL = 0.05  # the stencil phase against direct2's CUDA-event time
_OBS_D2_WARMUP, _OBS_D2_ITERS = 40, 20  # direct2's CUDA-event time: launches
_OBS_LEDGER_TOL = 0.01  # the headline with a ledger against it without one
_OBS_RANGE_ROUNDS = 12  # faces-direct tb=1: rounds of (on, off, off, on) runs
_OBS_RANGE_CHUNK = 10  # supersteps a run


def _obs_cli(root: str, tag: str, grid: int, mesh, tb: int, steps: int, extra) -> dict:
    """One profiled command-line run with a ledger: its summary, the ledger
    linted clean (taxonomy on), the events the run must hold, the capture
    engaged (a capture that failed soft fails here), and the trace's device
    activity (``obs.perf.timeline.device_activity``)."""
    from heat3d_tpu_torch.obs.check import check_file
    from heat3d_tpu_torch.obs.perf.roofline import step_cost_fields
    from heat3d_tpu_torch.obs.perf.timeline import device_activity, load_trace

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    for k in ("HEAT3D_LEDGER", "HEAT3D_FAULTS", "HEAT3D_NO_DIRECT", "HEAT3D_MEHRSTELLEN"):
        env.pop(k, None)
    led = os.path.join(root, f"{tag}.jsonl")
    prof = os.path.join(root, f"{tag}_prof")
    argv = [sys.executable, "-m", "heat3d_tpu_torch", "--grid", str(grid), "--steps",
            str(steps), "--time-blocking", str(tb), "--mesh", *map(str, mesh),
            "--device", "cuda:0", *extra, "--ledger", led, "--profile", prof]
    t0 = time.perf_counter()
    p = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=600, cwd=here)
    wall = time.perf_counter() - t0
    _check(p.returncode == 0, f"obs {tag}: the CLI exited {p.returncode}: {p.stderr[-2000:]}")
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    defects = check_file(led, taxonomy=True)
    _check(defects == [], f"obs {tag}: the ledger has defects: {defects[:5]}")
    evs = [json.loads(line) for line in open(led) if line.strip()]
    names = [e["event"] for e in evs]
    for want in ("run_start", "warmup", "run_loop", "step_cost", "profile_capture",
                 "run_summary", "metrics_summary"):
        _check(want in names, f"obs {tag}: the ledger lacks {want}: {names}")
    cost = next(e for e in evs if e["event"] == "step_cost")
    from heat3d_tpu_torch.core.config import GridConfig, MeshConfig, SolverConfig

    cfg = SolverConfig(grid=GridConfig.cube(grid), mesh=MeshConfig(shape=mesh),
                       time_blocking=tb, halo="dma" if "dma" in extra else "ppermute",
                       overlap="--overlap" in extra)
    want_bytes = step_cost_fields(cfg)["cost_bytes_per_step"]
    _check(cost["ok"] and cost["platform"] == "cuda"
           and cost["cost_bytes_per_step"] == want_bytes,
           f"obs {tag}: step_cost {cost} against the analytic {want_bytes}")
    cap = next(e for e in evs if e["event"] == "profile_capture")
    _check(cap["ok"] and os.path.exists(cap.get("artifact", "")),
           f"obs {tag}: the profile capture degraded: {cap}")
    loop = next(e for e in evs if e["event"] == "run_loop")
    act = device_activity(load_trace(cap["artifact"]))
    launched = {k: v for k, v in summary["kernel_launches"].items() if v}
    for name in launched:
        _check(any(_TRACE_NAMES[name] in k for k in act["kernels"]),
               f"obs {tag}: {name} ({_TRACE_NAMES[name]}) is not in the trace")
    _check(act["assigned"]["correlation"] > 0,
           f"obs {tag}: no device event joined its launch: {act['assigned']}")
    total = sum(act["phase_us"].values())
    phases = {k: v for k, v in act["phase_us"].items()
              if k in ("step", "stencil", "halo_exchange", "fused_dma", "residual")}
    supersteps = -(-steps // tb)
    kernel_ms = {name: sum(v["us"] for k, v in act["kernels"].items()
                           if _TRACE_NAMES[name] in k) / 1e3 / supersteps
                 for name in launched}
    return {"summary": summary, "activity": act, "cost": cost, "capture": cap,
            "kernel_ms_per_superstep": kernel_ms, "ranges_per_superstep":
            act["host_ranges"] / supersteps,
            "loop_s": loop["elapsed_s"], "wall_s": wall, "route": summary["superstep_route"]
            or summary["step_route"], "phase_share": sum(phases.values()) / max(total, 1e-9),
            "phase_ms_per_superstep": {k: v / 1e3 / supersteps
                                       for k, v in act["phase_us"].items()},
            "launched": launched, "trace_mb": os.path.getsize(cap["artifact"]) / 1e6}


def _obs_bench_pair(cfg, on, off) -> dict:
    """``bench_throughput`` of ``cfg`` (every shard on cuda:0) in the turns
    off, on, on, off, ``on()`` before the runs marked on and ``off()`` after
    them: Gcell/s and ms per superstep of each."""
    from heat3d_tpu_torch.bench.harness import bench_throughput

    rows = {True: [], False: []}
    for flag in (False, True, True, False):
        if flag:
            on()
        try:
            r = bench_throughput(cfg, steps=20, repeats=3, device="cuda:0")
        finally:
            if flag:
                off()
        rows[flag].append({"gcell": r["gcell_updates_per_sec"], "ms": r["ms_per_launch"]})
    return rows


def _obs_range_cost(cfg, hooks, rounds=_OBS_RANGE_ROUNDS, chunk=_OBS_RANGE_CHUNK) -> dict:
    """The phase ranges' cost on ``cfg`` (every shard on cuda:0), measured
    unprofiled: one solver, ``rounds`` rounds of four ``chunk``-superstep
    runs in the order on, off, off, on (the next round off, on, on, off),
    the ranges switched between runs (``hooks`` on, none off). Each run
    gives its host time to issue the chunk (the call's return, before any
    sync) and its wall time until the card is idle, both in ms a superstep.
    Returns each side's readings with their median, least and greatest, and
    the median over rounds of each round's on/off ratio (the same host
    drift lands on both sides of a round)."""
    import statistics

    import torch

    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.obs import trace as obs_trace

    solver = HeatSolver3D(cfg, device="cuda:0")
    u = solver.init_state("hot-cube")
    u = solver.run(u, chunk)
    torch.cuda.synchronize()
    runs = {"host": {True: [], False: []}, "wall": {True: [], False: []}}
    ratios = {"host": [], "wall": []}
    try:
        for r in range(rounds):
            first = r % 2 == 0
            per = {"host": {True: [], False: []}, "wall": {True: [], False: []}}
            for flag in (first, not first, not first, first):
                obs_trace._HOOKS = hooks if flag else (None, None, None)
                t0 = time.perf_counter()
                u = solver.run(u, chunk)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                for key, dt in (("host", t1 - t0), ("wall", t2 - t0)):
                    ms = dt / chunk * 1e3
                    runs[key][flag].append(ms)
                    per[key][flag].append(ms)
            for key in ratios:
                ratios[key].append(sum(per[key][True]) / sum(per[key][False]))
    finally:
        obs_trace._HOOKS = hooks
    del u, solver
    torch.cuda.empty_cache()

    def side(xs):
        return {"ms": xs, "median": statistics.median(xs), "min": min(xs), "max": max(xs)}

    return {key: {"on": side(runs[key][True]), "off": side(runs[key][False]),
                  "on_over_off": statistics.median(ratios[key]),
                  "on_over_off_range": [min(ratios[key]), max(ratios[key])]}
            for key in runs}


def phase_obs(smi: str, bw: float) -> dict:
    """Observability on the card: the command line with ``--ledger`` and
    ``--profile`` (``_OBS_RUNS``) — each ledger lints clean with the
    taxonomy on and holds its run's events, ``step_cost`` equal to the
    analytic count, each capture engaged and every kernel the route
    launched on the device by name; the headline's device time at least
    ``_OBS_PHASE_SHARE`` under a ``heat3d.*`` phase and its stencil phase
    per superstep within ``_OBS_STENCIL_TOL`` of direct2's CUDA-event time;
    each run's device ms per phase and superstep, its device busy share and
    its five longest idle gaps with the host range open in each. Then, in
    this process: the headline's Gcell/s with a ledger against without
    (within ``_OBS_LEDGER_TOL``) and faces-direct tb=1's time a superstep
    with the phase ranges against without them (``_obs_range_cost``);
    ``obs roofline`` live on the headline (achieved GB/s per phase against
    the card's rate, GFLOP/s against its fp32 rate) and ``--calibrate``
    (what the 27pt chain achieves), beside the card's name and power
    limit."""
    import tempfile

    import torch

    from heat3d_tpu_torch import obs, ops
    from heat3d_tpu_torch.core.config import GridConfig, MeshConfig, SolverConfig
    from heat3d_tpu_torch.obs import trace as obs_trace
    from heat3d_tpu_torch.obs.perf import roofline
    from heat3d_tpu_torch.ops.stencil_direct import apply_taps_direct2
    from heat3d_tpu_torch.utils.timing import time_fn

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="heat3d_obs_")
    res = {}
    try:
        ops.reset_launch_counts()
        runs = {}
        for tag, grid, mesh, tb, steps, extra in _OBS_RUNS:
            r = runs[tag] = _obs_cli(root, tag, grid, mesh, tb, steps, extra)
            act = r["activity"]
            _say("obs_run", card=smi, run=tag, grid=[grid] * 3, mesh=list(mesh),
                 time_blocking=tb, steps=steps, route=r["route"],
                 gcell_updates_per_sec=r["summary"]["gcell_updates_per_sec"],
                 run_loop_s=r["loop_s"], cli_wall_s=r["wall_s"],
                 phase_ms_per_superstep=r["phase_ms_per_superstep"],
                 phase_share=r["phase_share"], busy_us=act["busy_us"],
                 window_us=act["window_us"], busy_share=act["busy_share"],
                 idle_gaps=act["gaps"], device_events=act["events"],
                 joined=act["assigned"], kernels_launched=r["launched"],
                 kernel_ms_per_superstep=r["kernel_ms_per_superstep"],
                 ranges_per_superstep=r["ranges_per_superstep"],
                 trace_mb=r["trace_mb"], cost_bytes_per_step=r["cost"]["cost_bytes_per_step"],
                 capture_overhead_s=r["capture"]["enter_overhead_s"]
                 + r["capture"]["exit_overhead_s"])
        head = runs["headline"]
        _check(head["phase_share"] >= _OBS_PHASE_SHARE,
               f"obs: {head['phase_share']:.4f} of the headline's device time lies under a "
               f"heat3d phase (< {_OBS_PHASE_SHARE})")
        # the stencil phase's device time per superstep: its direct2 launches
        # (the remainder and residual steps launch direct1 there too)
        kern = head["activity"]["kernels"]
        d2 = [v for k, v in kern.items() if _TRACE_NAMES["apply_taps_direct2"] in k]
        d1_us = sum(v["us"] for k, v in kern.items() if _TRACE_NAMES["apply_taps_direct"] in k)
        d2_count = sum(v["count"] for v in d2)
        stencil_ms = (head["activity"]["phase_us"]["stencil"] - d1_us) / 1e3 / d2_count
        n = 1024
        u = torch.rand((n, n, n), device="cuda:0")
        out = torch.empty_like(u)
        taps = _taps("7pt")
        # ~0.2 s of warmup launches first: the card sat idle through the
        # CLI's exit, and one reading of 5 calls after 2 warmups ran 5% slow
        d2_ms = min(time_fn(lambda: apply_taps_direct2(u, taps, False, 0.0, out=out),
                            warmup=_OBS_D2_WARMUP, iters=_OBS_D2_ITERS)) * 1e3
        del u, out
        torch.cuda.empty_cache()
        _check(abs(stencil_ms / d2_ms - 1) <= _OBS_STENCIL_TOL,
               f"obs: the headline's stencil phase {stencil_ms:.3f} ms a superstep against "
               f"direct2's CUDA-event {d2_ms:.3f} ms")
        res["headline"] = {"phase_share": head["phase_share"], "stencil_ms": stencil_ms,
                           "direct2_event_ms": d2_ms,
                           "busy_share": head["activity"]["busy_share"]}
        _say("obs_headline", card=smi, **res["headline"], direct2_launches=d2_count)

        # the ledger's cost on the headline, the phase ranges' on faces-direct
        led = os.path.join(root, "bench.jsonl")
        headline = SolverConfig(grid=GridConfig.cube(1024), time_blocking=2)
        pair = _obs_bench_pair(headline, lambda: obs.activate(led), lambda: obs.deactivate())
        on = sum(r["gcell"] for r in pair[True]) / 2
        off = sum(r["gcell"] for r in pair[False]) / 2
        _check(abs(on / off - 1) <= _OBS_LEDGER_TOL,
               f"obs: the headline with a ledger {on:.2f} Gcell/s against {off:.2f} without")
        hooks = obs_trace._hooks()
        faces = SolverConfig(grid=GridConfig.cube(1024), mesh=MeshConfig(shape=_MESH))
        ranges = _obs_range_cost(faces, hooks)
        # one range's host cost (unprofiled: NVTX push/pop and a flag read)
        # against none, times the ranges a faces-direct superstep opens
        per_range = {}
        for tag, h in (("on", hooks), ("off", (None, None, None))):
            obs_trace._HOOKS = h
            t1 = time.perf_counter()
            for _ in range(20000):
                with obs_trace.named_phase("stencil"):
                    pass
            per_range[tag] = (time.perf_counter() - t1) / 20000 * 1e6
        obs_trace._HOOKS = hooks
        faces_ms = ranges["wall"]["off"]["median"]
        per_step_us = (per_range["on"] - per_range["off"]) * runs["faces-direct"][
            "ranges_per_superstep"]
        res["ledger"] = {"on": pair[True], "off": pair[False], "ratio": on / off}
        res["ranges"] = {**ranges, "range_us": per_range, "per_superstep_us": per_step_us,
                         "of_superstep": per_step_us / 1e3 / faces_ms}
        _say("obs_cost", card=smi, headline_ledger=res["ledger"],
             faces_direct_phase_ranges=res["ranges"])

        # obs roofline live on the headline, and --calibrate on the card
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = roofline.main(["--grid", "1024", "--time-blocking", "2", "--iters", "5",
                                "--json"])
        _check(rc == 0, "obs roofline (live) failed")
        live = json.loads(buf.getvalue().strip().splitlines()[-1])
        store = os.path.join(root, "tune_cache.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = roofline.main(["--calibrate", "--grid", "512", "--iters", "5", "--cache",
                                store, "--json"])
        _check(rc == 0, "obs roofline --calibrate failed")
        cal = json.loads(buf.getvalue().strip().splitlines()[-1])
        peak_gbps = bw / 1e9
        peak_gflops = roofline.FP32_FLOPS / 1e9
        res["roofline"] = {p["phase"]: {"gbps": p.get("gbps"), "gflops": p.get("gflops"),
                                        "ms": p["seconds"] * 1e3,
                                        "of_peak_mem": p["gbps"] / peak_gbps,
                                        "of_peak_fp32": (p["gflops"] or 0) / peak_gflops}
                           for p in live["phases"] if "error" not in p}
        res["calibrated_vector_gflops"] = cal["vector_gflops"]
        _check(roofline.peak_spec("cuda")["vector_gflops"] == peak_gflops,
               "obs: the calibrated rate became the roofline's vector peak")
        _say("obs_roofline", card=smi, platform=live["platform"], peak_mem_gbps=peak_gbps,
             peak_fp32_gflops=peak_gflops,
             phases=res["roofline"], calibrated_chip=cal["chip"],
             calibrated_vector_gflops=cal["vector_gflops"],
             calibrated_of_fp32_peak=cal["vector_gflops"] * 1e9 / roofline.FP32_FLOPS)
        launches = ops.launch_counts()
        for name in ("apply_taps_direct", "apply_taps_direct2"):
            _check(launches[name] > 0, f"obs: {name} was not launched in this phase")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _say("obs_path", card=smi, kernel_launches=launches, seconds=time.perf_counter() - t0)
    return res


# the tune phase: its one-shard search, the sharded search's knobs and
# budget, and the comm probe's bench_halo forms at 1024^3 on (2,2,2)
_TUNE_KNOBS = ("backend=pallas,jnp", "time_blocking=1,2,3,4")
_TUNE_SHARDED_KNOBS = ("halo=ppermute,dma", "overlap=0,1", "time_blocking=1,2",
                       "fused_rdma=off,on", "halo_plan=monolithic,partitioned")
_TUNE_SHARDED_BUDGET_S = 75
_TUNE_TOL = 0.03  # the resolved runs against their explicit twins, the winner
_TUNE_PROBE_FORMS = (("ppermute", "monolithic"), ("ppermute", "partitioned"),
                     ("dma", "monolithic"))
# PERF.md section 5's fused rows, printed beside the sharded winner
_TUNE_FUSED_REF = {"fused-dma2 (8,1,1)": 333.29, "fused-rdma2 (4,1,1)": 351.78}


def _tune_cmd(argv) -> tuple:
    """``tune ...`` in this process: (exit code, stdout)."""
    from heat3d_tpu_torch.tune.cli import main as tune_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tune_main(list(argv))
    return rc, buf.getvalue()


def _tune_cli_run(led: str, tb: int, extra=()) -> tuple:
    """The solver command line at 1024^3 (one shard, ``--backend pallas``,
    20 steps) in this process with a ledger: (summary, ledger events)."""
    from heat3d_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["--grid", "1024", "--mesh", "1", "1", "1", "--backend", "pallas",
                       "--steps", "20", "--time-blocking", str(tb), "--ledger", led,
                       *extra])
    _check(rc == 0, f"tune: the command line exited {rc} (tb {tb})")
    evs = [json.loads(line) for line in open(led) if line.strip()]
    return json.loads(buf.getvalue().strip().splitlines()[-1]), evs


def _tune_resolution(root: str, store: str, smi: str) -> dict:
    """Step 2: the command line with ``--time-blocking 0`` against the
    search's store (hit: tb 2), under ``HEAT3D_TUNE_DISABLE=1`` (tb 1) and
    against a copy of the store whose entry's kernels digest is altered
    (stale: tb 1), each beside its explicit twin in the turns auto,
    explicit, explicit, auto (the means compared: one 20-step run on the
    host clock drifts by a few percent between runs); and no device memory
    allocated by ``resolve_config`` on a hit."""
    import statistics

    import torch

    from heat3d_tpu_torch.core.config import GridConfig, SolverConfig
    from heat3d_tpu_torch.tune.cache import cache_key, resolve_config

    res = {}
    stale_store = os.path.join(root, "stale_cache.json")
    doc = json.load(open(store))
    key = cache_key(SolverConfig(grid=GridConfig.cube(1024)))
    _check(key in doc["entries"], f"tune: no entry {key} in the store: {sorted(doc['entries'])}")
    doc["entries"][key]["provenance"]["kernels"] = "0" * 16
    with open(stale_store, "w") as f:
        json.dump(doc, f)
    cases = (("hit", store, {}, 2, "tune_cache_hit"),
             ("disabled", store, {"HEAT3D_TUNE_DISABLE": "1"}, 1, None),
             ("stale", stale_store, {}, 1, "tune_cache_stale"))
    for tag, path, env, want_tb, want_event in cases:
        gcell = {"auto": [], "explicit": []}
        with _env(HEAT3D_TUNE_CACHE=path, **env):
            for i, side in enumerate(("auto", "explicit", "explicit", "auto")):
                summary, evs = _tune_cli_run(os.path.join(root, f"{tag}_{i}.jsonl"),
                                             0 if side == "auto" else want_tb)
                gcell[side].append(summary["gcell_updates_per_sec"])
                if side == "explicit":
                    continue
                start = next(e for e in evs if e["event"] == "run_start")
                tune_evs = [e for e in evs if e["event"].startswith("tune_cache")]
                _check(start["time_blocking"] == want_tb
                       and summary["time_blocking"] == want_tb,
                       f"tune {tag}: run_start tb {start['time_blocking']}, summary tb "
                       f"{summary['time_blocking']}, want {want_tb}")
                _check([e["event"] for e in tune_evs] == ([want_event] if want_event else []),
                       f"tune {tag}: resolution events {tune_evs}")
                if tag == "hit":
                    _check(tune_evs[0]["applied"] == {"time_blocking": 2},
                           f"tune hit: applied {tune_evs[0]['applied']}")
                if tag == "stale":
                    _check("kernels" in tune_evs[0]["reason"], f"tune stale: {tune_evs[0]}")
        auto, twin = statistics.mean(gcell["auto"]), statistics.mean(gcell["explicit"])
        _check(abs(auto / twin - 1) <= _TUNE_TOL,
               f"tune {tag}: {gcell['auto']} Gcell/s against the explicit tb={want_tb} "
               f"runs' {gcell['explicit']}")
        res[tag] = {"time_blocking": want_tb, "gcell": gcell["auto"],
                    "explicit_gcell": gcell["explicit"], "ratio": auto / twin,
                    "events": [{k: e.get(k) for k in ("event", "applied", "reason")}
                               for e in tune_evs]}
        _say("tune_resolution", card=smi, case=tag, **res[tag])
    # a hit's build check builds a solver: no field may be allocated, not
    # even for a moment (the peak since a reset stays where it was)
    cfg = SolverConfig(grid=GridConfig.cube(1024), backend="pallas", time_blocking=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with _env(HEAT3D_TUNE_CACHE=store):
        got = resolve_config(cfg)
    torch.cuda.synchronize()
    after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    _check(got.time_blocking == 2 and after == before and peak == before,
           f"tune: resolve_config gave tb {got.time_blocking}, memory_allocated "
           f"{before} -> {after}, peak {peak}")
    res["memory_allocated"] = [before, after, peak]
    _say("tune_resolution_memory", card=smi, memory_allocated_before=before,
         memory_allocated_after=after, max_memory_allocated=peak)
    return res


def _tune_probe(root: str, smi: str) -> str:
    """Step 4: ``bench_halo`` at 1024^3 on (2,2,2) (every shard on cuda:0)
    under ``HEAT3D_COMM_PROBE=1`` in ``_TUNE_PROBE_FORMS``: one comm_probe
    event per link of the schedule with its predicted bytes, ``obs
    summary``'s comm section. Returns the ledger."""
    import torch

    from heat3d_tpu_torch import obs
    from heat3d_tpu_torch.bench.harness import bench_halo
    from heat3d_tpu_torch.core.config import GridConfig, MeshConfig, SolverConfig
    from heat3d_tpu_torch.obs.cli import main as obs_main
    from heat3d_tpu_torch.obs.comm.probe import probe_links
    from heat3d_tpu_torch.parallel.plan import make_schedule

    led = os.path.join(root, "probe.jsonl")
    for halo, plan in _TUNE_PROBE_FORMS:
        cfg = SolverConfig(grid=GridConfig.cube(1024), mesh=MeshConfig(shape=_MESH),
                           halo=halo, halo_plan=plan)
        links = probe_links(make_schedule(_MESH, 1, plan, "axis"), cfg.local_shape, 4)
        obs.activate(led, meta={"entry": "chip_smoke_tune"})
        try:
            with _env(HEAT3D_COMM_PROBE="1"):
                row = bench_halo(cfg, iters=5, device="cuda:0")
        finally:
            obs.deactivate(rc=0)
        evs = [json.loads(line) for line in open(led) if line.strip()]
        probes = [e for e in evs if e["event"] == "comm_probe" and e["halo"] == halo
                  and e["plan_mode"] == plan]
        _check(len(probes) == len(links)
               and [e["bytes_predicted"] for e in probes]
               == [ln["bytes_predicted"] for ln in links]
               and [e["scope"] for e in probes] == [ln["scope"] for ln in links],
               f"tune probe {halo}/{plan}: {len(probes)} comm_probe events for "
               f"{len(links)} links: {[(e['scope'], e['bytes_predicted']) for e in probes]}")
        _say("tune_probe", card=smi, halo=halo, halo_plan=plan, p50_us=row["p50_us"],
             links=[{k: e[k] for k in ("scope", "bytes_predicted", "t_s", "gbps", "senders",
                                        "gbps_senders", "trips", "rtt_dominated")}
                    for e in probes])
        _BENCH_ROWS.append(dict(row))
        del row
        torch.cuda.empty_cache()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_main(["summary", led])
    _check(rc == 0 and "comm links (probe)" in buf.getvalue(),
           f"tune probe: obs summary rc {rc} without the comm section")
    return led


def phase_tune(smi: str, bw: float) -> dict:
    """Autotuning on the card, in a temporary directory (store and
    ledgers), every line with the card's name and power limit: (1) ``tune
    run`` at 1024^3 on one shard over ``_TUNE_KNOBS`` — each trial, the
    winner (pallas tb=2, within ``_TUNE_TOL`` of this run's main-path tb=2
    figure, or of this phase's own tb=2 bench row under ``--only``), its
    speed-up over the static default, the enumeration time (and the
    default lattice's at 1024^3), ``tune lint`` clean, ``obs check`` clean
    with one ``tune_search_start``, one ``tune_trial`` per candidate and one
    ``tune_winner``; (2) resolution through the command line
    (``_tune_resolution``); (3) ``tune run`` at 1024^3 on (8,1,1) with every
    shard on cuda:0 over ``_TUNE_SHARDED_KNOBS`` within a budget — pruned
    candidates with their reasons, trials, the winner and its key (the
    ``s8`` leg), beside PERF.md's fused rows: the sharded path's overhead
    on one card, not a multi-GPU figure; (4) the comm probe
    (``_tune_probe``); (5) ``obs adjudicate`` over the bench rows of (1) and
    (4): no stage ``fail``, the slab-width and halo-plan stages ``pass``."""
    import tempfile

    import torch

    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.core.config import GridConfig, SolverConfig
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.obs.check import check_file
    from heat3d_tpu_torch.obs.comm.adjudicate import main as adjudicate_main
    from heat3d_tpu_torch.tune.space import DEFAULT_KNOBS, enumerate_candidates

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="heat3d_tune_")
    store = os.path.join(root, "tune_cache.json")
    res = {}
    try:
        # (1) the one-shard search
        led1 = os.path.join(root, "search.jsonl")
        knobs = [a for k in _TUNE_KNOBS for a in ("--knob", k)]
        rc, out = _tune_cmd(["run", "--grid", "1024", "--mesh", "1", "1", "1", *knobs,
                             "--steps", "20", "--repeats", "2", "--probe-steps", "4",
                             "--cache", store, "--ledger", led1, "--json"])
        _check(rc == 0, f"tune run (one shard) exited {rc}: {out[-2000:]}")
        search = json.loads(out.strip().splitlines()[-1])
        win = search["winner"]
        if _MAIN_PATH_TB2:
            ref, ref_from = _MAIN_PATH_TB2[-1], "main_path"
        else:
            row = bench_throughput(SolverConfig(grid=GridConfig.cube(1024), time_blocking=2),
                                   steps=20, warmup=1, repeats=3)
            ref, ref_from = row["gcell_updates_per_sec"], "this phase's bench_throughput"
            del row
            torch.cuda.empty_cache()
        _check(win is not None and win["knobs"] == {"backend": "pallas", "time_blocking": "2"},
               f"tune run: winner {win}, want pallas tb=2")
        _check(abs(win["gcell_per_sec_per_chip"] / ref - 1) <= _TUNE_TOL,
               f"tune run: the winner's {win['gcell_per_sec_per_chip']:.2f} Gcell/s against "
               f"{ref:.2f} ({ref_from})")
        # the default lattice at 1024^3 on one shard: its enumeration cost
        with _env(HEAT3D_TUNE_DISABLE="1"):
            te = time.perf_counter()
            lattice = enumerate_candidates(SolverConfig(grid=GridConfig.cube(1024)),
                                           DEFAULT_KNOBS, make_solver=HeatSolver3D)
            lattice_s = time.perf_counter() - te
        _check(rc == 0 and _tune_cmd(["lint", "--cache", store])[0] == 0,
               "tune lint failed on the search's store")
        defects = check_file(led1, taxonomy=True)
        names = [json.loads(line)["event"] for line in open(led1) if line.strip()]
        _check(defects == [] and names.count("tune_search_start") == 1
               and names.count("tune_trial") == len(search["trials"])
               and names.count("tune_winner") == 1,
               f"tune run: ledger defects {defects[:5]}; events "
               f"{ {n: names.count(n) for n in set(names) if n.startswith('tune')} }")
        res["search"] = {"key": search["key"], "winner": win, "reference": ref,
                         "reference_from": ref_from,
                         "speedup_vs_default": search["speedup_vs_default"]}
        _say("tune_search", card=smi, key=search["key"], trials=search["trials"],
             winner=win, speedup_vs_default=search["speedup_vs_default"],
             reference_gcell=ref, reference_from=ref_from,
             winner_over_reference=win["gcell_per_sec_per_chip"] / ref,
             enumerate_s=search["enumerate_s"], elapsed_s=search["elapsed_s"],
             default_lattice_candidates=len(lattice),
             default_lattice_pruned=sum(1 for c in lattice if c.prune),
             default_lattice_enumerate_s=lattice_s,
             default_lattice_ms_per_candidate=lattice_s / len(lattice) * 1e3)
        del lattice

        # (2) resolution through the command line
        res["resolution"] = _tune_resolution(root, store, smi)

        # (3) the sharded search, every shard on cuda:0
        led3 = os.path.join(root, "sharded.jsonl")
        knobs = [a for k in _TUNE_SHARDED_KNOBS for a in ("--knob", k)]
        rc, out = _tune_cmd(["run", "--grid", "1024", "--mesh", "8", "1", "1", "--device",
                             "cuda:0", *knobs, "--steps", "20", "--repeats", "2",
                             "--probe-steps", "4", "--budget-s", str(_TUNE_SHARDED_BUDGET_S),
                             "--cache", store, "--ledger", led3, "--json"])
        _check(rc == 0, f"tune run (8,1,1) exited {rc}: {out[-2000:]}")
        sharded = json.loads(out.strip().splitlines()[-1])
        _check(sharded["key"].endswith("|s8"), f"tune run (8,1,1): key {sharded['key']}")
        _check(check_file(led3, taxonomy=True) == [], "tune run (8,1,1): ledger defects")
        res["sharded"] = {"key": sharded["key"], "winner": sharded["winner"]}
        _say("tune_sharded", card=smi, key=sharded["key"],
             note="every shard on cuda:0: the sharded path's overhead on one card, "
                  "not a multi-GPU figure",
             pruned=[{"knobs": t["knobs"], "reason": t["reason"]}
                     for t in sharded["trials"] if t["status"] == "pruned"],
             trials=[t for t in sharded["trials"] if t["status"] != "pruned"],
             winner=sharded["winner"], speedup_vs_default=sharded["speedup_vs_default"],
             perf_md_fused_rows=_TUNE_FUSED_REF, enumerate_s=sharded["enumerate_s"],
             elapsed_s=sharded["elapsed_s"], budget_s=sharded["budget_s"])

        # (4) the comm probe, (5) adjudication over (1) and (4)
        led4 = _tune_probe(root, smi)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = adjudicate_main([led1, led4, "--json"])
        verdict = json.loads(buf.getvalue().strip().splitlines()[-1])
        stages = {s["stage"]: s for s in verdict["stages"]}
        _check(rc == 0 and all(s["verdict"] != "fail" for s in stages.values())
               and stages["slab_width"]["verdict"] == "pass"
               and stages["halo_plan"]["verdict"] == "pass",
               f"obs adjudicate: rc {rc}, {[(k, s['verdict']) for k, s in stages.items()]}")
        res["adjudicate"] = {k: s["verdict"] for k, s in stages.items()}
        _say("tune_adjudicate", card=smi, verdict=verdict["verdict"], rows=verdict["rows"],
             stages={k: {"verdict": s["verdict"], "reason": s["reason"],
                         "winners": s["winners"]} for k, s in stages.items()})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _say("tune_path", card=smi, seconds=time.perf_counter() - t0)
    return res


# ---- serving (the batched ensemble behind the request queue) ---------------

# bucket -> (requests, what varies); the grids serving users run on one card
_SERVE_BUCKETS = ("A", "B", "C", "D", "E")
_SERVE_INITS = ("hot-cube", "gaussian", "random")
_SERVE_COEF = ("uniform", "layered", "checker", "lognormal")
# the golden gate of the command line: fp32 chain 1e-5, bf16 anywhere 5e-2
_SERVE_GOLDEN_TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _serve_records(seed: int = 0) -> list:
    """The 168 requests of the serve phase, (bucket, record) in a seeded
    shuffled submission order: A 128 x 128^3 7pt fp32 tb=1 (alpha 0.2-1.0,
    bc 0/1, 50-200 steps, three inits); B 16 x 256^3 27pt tb=2 (20-60
    steps); C 8 x 128^3 coefficient fields (four names x two seeds); D 8 x
    128^3 advection-diffusion (vx 0.5-2.0); E 8 x 128^3 bf16 storage
    (10-40 steps)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def alpha():
        return round(float(rng.uniform(0.2, 1.0)), 4)

    recs = []
    for i in range(128):
        recs.append(("A", {"grid": 128, "steps": int(rng.integers(50, 201)), "alpha": alpha(),
                           "bc_value": float(i % 2), "init": _SERVE_INITS[i % 3], "seed": i}))
    for i in range(16):
        recs.append(("B", {"grid": 256, "stencil": "27pt", "time_blocking": 2,
                           "steps": int(rng.integers(20, 61)), "alpha": alpha(),
                           "init": _SERVE_INITS[i % 3], "seed": 200 + i}))
    for i in range(8):
        recs.append(("C", {"grid": 128, "coef_field": [_SERVE_COEF[i % 4], i // 4],
                           "steps": int(rng.integers(40, 81)), "bc_value": float(i % 2),
                           "init": _SERVE_INITS[i % 3], "seed": 300 + i}))
    for i in range(8):
        recs.append(("D", {"grid": 128, "equation": "advection-diffusion",
                           "eq_params": {"vx": round(float(rng.uniform(0.5, 2.0)), 4)},
                           "steps": int(rng.integers(50, 101)), "init": _SERVE_INITS[i % 3],
                           "seed": 400 + i}))
    for i in range(8):
        # bf16 storage drifts ~8e-4 (relative) a step at 128^3 against the
        # fp64 golden, bc 1 (the CLI's own 5e-2 gate holds to ~60 steps):
        # E's budgets stay where the gate is known to hold
        recs.append(("E", {"grid": 128, "dtype": "bf16", "steps": int(rng.integers(10, 41)),
                           "alpha": alpha(), "bc_value": float(i % 2),
                           "init": _SERVE_INITS[i % 3], "seed": 500 + i}))
    order = rng.permutation(len(recs))
    return [recs[i] for i in order]


def _golden_batch(u0, taps, bcv, budgets):
    """The fp64 golden (``core.golden.step``: ghost pad, then ``out += w *
    slice`` over the nonzero taps in their order) of a batch of Dirichlet
    members on the card: u0 (B, n, n, n) float64, per-member taps (B of
    3x3x3) and boundary values, each member frozen at its budget."""
    import numpy as np
    import torch

    from heat3d_tpu_torch.core.stencils import nonzero_taps

    B, n = u0.shape[0], u0.shape[1:]
    offs = [d for d, _ in nonzero_taps(taps[0])]
    W = torch.tensor([[t[di + 1, dj + 1, dk + 1] for di, dj, dk in offs] for t in taps],
                     dtype=torch.float64, device=u0.device)
    bc = torch.tensor(bcv, dtype=torch.float64, device=u0.device).reshape(B, 1, 1, 1)
    left = torch.tensor(np.asarray(budgets), device=u0.device)
    up = torch.empty((B,) + tuple(m + 2 for m in n), dtype=torch.float64, device=u0.device)
    u = u0
    for i in range(int(max(budgets))):
        up[:] = bc
        up[:, 1:-1, 1:-1, 1:-1] = u
        out = torch.zeros_like(u)
        for j, (di, dj, dk) in enumerate(offs):
            out += W[:, j].reshape(B, 1, 1, 1) * up[:, 1 + di:1 + di + n[0],
                                                     1 + dj:1 + dj + n[1], 1 + dk:1 + dk + n[2]]
        u = torch.where((left > i).reshape(B, 1, 1, 1), out, u)
    return u


def _varcoef_golden_batch(u0, a, dts, bcv, budgets):
    """``timeint.coeffield.reference_varcoef_step`` (Dirichlet) in fp64 on
    the card over a batch of members, each frozen at its budget."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    B, n = u0.shape[0], u0.shape[1:]
    f = torch.tensor(dts, dtype=torch.float64, device=u0.device).reshape(B, 1, 1, 1)
    bc = torch.tensor(bcv, dtype=torch.float64, device=u0.device).reshape(B, 1, 1, 1)
    left = torch.tensor(np.asarray(budgets), device=u0.device)
    apd = F.pad(a, (1, 1, 1, 1, 1, 1))
    up = torch.empty_like(apd)

    def slab(arr, axis, off):
        sl = [slice(None)]
        for ax in range(3):
            o = off if ax == axis else 0
            sl.append(slice(1 + o, 1 + o + n[ax]))
        return arr[tuple(sl)]

    u = u0
    for i in range(int(max(budgets))):
        up[:] = bc
        up[:, 1:-1, 1:-1, 1:-1] = u
        uc, ac = slab(up, 0, 0), slab(apd, 0, 0)
        acc = uc.clone()
        for axis in range(3):
            u_p, u_m = slab(up, axis, 1), slab(up, axis, -1)
            a_p, a_m = slab(apd, axis, 1), slab(apd, axis, -1)
            acc += f * (0.5 * (ac + a_p) * (u_p - uc) - 0.5 * (a_m + ac) * (uc - u_m))
        u = torch.where((left > i).reshape(B, 1, 1, 1), acc, u)
    return u


def _serve_golden(bucket, base, members, fields) -> float:
    """The largest golden relative error (max |u - g| / max |g|, the
    command line's) over ``members``, whose served fields are ``fields``;
    fails past the gate."""
    import numpy as np
    import torch

    from heat3d_tpu_torch.core import golden
    from heat3d_tpu_torch.serve.scenario import ScenarioBatch

    batch = ScenarioBatch(base, members)
    u0 = torch.from_numpy(np.stack([
        golden.make_init(m.init, base.grid.shape, seed=m.seed) for m in members
    ]).astype(np.float64)).cuda()
    budgets = [batch.member_steps(i) for i in range(len(members))]
    bcv = [m.bc_value for m in members]
    if batch.has_coef_fields:
        a = torch.from_numpy(np.stack([batch.member_coef_field(i)
                                       for i in range(len(members))])).cuda()
        g = _varcoef_golden_batch(u0, a, [batch.member_dt(i) for i in range(len(members))],
                                  bcv, budgets)
    else:
        g = _golden_batch(u0, [batch.member_taps(i) for i in range(len(members))], bcv,
                          budgets)
    g = g.cpu().numpy()
    tol = _SERVE_GOLDEN_TOL[base.precision.storage]
    worst = 0.0
    for i in range(len(members)):
        rel = float(np.max(np.abs(fields[i] - g[i]))) / max(float(np.max(np.abs(g[i]))), 1e-300)
        _check(rel < tol, f"serve golden: bucket {bucket} member {i}: rel err {rel} >= {tol}")
        worst = max(worst, rel)
    return worst


def _serve_golden_self_check() -> dict:
    """The card's fp64 goldens against their NumPy originals on one member
    of 128^3 (``core.golden.step`` 3 steps, ``reference_varcoef_step`` 2)."""
    import numpy as np
    import torch

    from heat3d_tpu_torch.core import golden
    from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps
    from heat3d_tpu_torch.timeint.coeffield import make_coef_field, reference_varcoef_step
    from heat3d_tpu_torch.core.config import BoundaryCondition

    n = (128,) * 3
    u = golden.make_init("random", n, seed=7).astype(np.float64)
    taps = stencil_taps(STENCILS["7pt"], 0.7, 0.1, (1.0, 1.0, 1.0))
    want = u
    for _ in range(3):
        want = golden.step(want, taps, BoundaryCondition.DIRICHLET, 1.0)
    got = _golden_batch(torch.from_numpy(u[None]).cuda(), [taps], [1.0], [3])[0].cpu().numpy()
    a = make_coef_field("lognormal", n, seed=1)
    want_v = reference_varcoef_step(reference_varcoef_step(u, a, 0.1, (1.0, 1.0, 1.0), False,
                                                           1.0), a, 0.1, (1.0, 1.0, 1.0),
                                    False, 1.0)
    got_v = _varcoef_golden_batch(torch.from_numpy(u[None]).cuda(),
                                  torch.from_numpy(a[None]).cuda(), [0.1], [1.0],
                                  [2])[0].cpu().numpy()
    res = {"heat_max_abs_diff": float(np.max(np.abs(got - want))),
           "varcoef_max_abs_diff": float(np.max(np.abs(got_v - want_v)))}
    _check(max(res.values()) <= 1e-12, f"serve: the card's fp64 golden vs NumPy's: {res}")
    return res


def _bucket_summary(led: str, labels: dict) -> dict:
    """Per bucket label: members, padded sizes, seconds (the ``serve_batch``
    spans: init, run and gather, and each part), Gcell/s of the live
    members' updates over those seconds and over the run's alone, request
    latency p50/p95/max (the drain-final ``serve_metrics_summary``) and the
    batches' peak device memory."""
    evs = [json.loads(line) for line in open(led) if line.strip()]
    summ = [e for e in evs if e.get("event") == "serve_metrics_summary"]
    _check(len(summ) == 1, f"serve: {len(summ)} serve_metrics_summary events")
    out = {}
    for key, label in labels.items():
        spans = [e for e in evs if e.get("event") == "serve_batch" and e.get("kind") == "span"
                 and e.get("bucket") == key]
        starts = [e for e in evs if e.get("event") == "serve_batch_start"
                  and e.get("bucket") == key]
        lat = summ[0]["buckets"][key]
        secs = sum(e["dur_s"] for e in spans)
        out[label] = {
            "requests": sum(e["members"] for e in starts),
            "batches": [{"members": e["members"], "padded": e["padded"]} for e in starts],
            "seconds": secs,
            "init_s": sum(e["init_s"] for e in spans),
            "run_s": sum(e["run_s"] for e in spans),
            "gather_s": sum(e["gather_s"] for e in spans),
            "gcell_per_sec": sum(e["cell_updates"] for e in spans) / secs / 1e9,
            "run_gcell_per_sec": sum(e["cell_updates"] for e in spans)
            / sum(e["run_s"] for e in spans) / 1e9,
            "latency_p50_s": lat["p50_s"], "latency_p95_s": lat["p95_s"],
            "latency_max_s": lat["max_s"],
            "peak_mem_gib": max(e["device_peak_bytes"] for e in spans) / 2**30,
        }
    return out


def phase_serve(smi: str) -> dict:
    """Serving on the card (part one: the synchronous queue over the
    batched ensemble), in a temporary directory, every line with the card's
    name and power limit: (1) the ``serve --requests --residuals`` command
    (its ``main``, in this process, so the kernel launch counts and the
    device memory are this run's) over the 168 records of :func:`_serve_records`
    at ``HEAT3D_SERVE_MAX_BATCH``'s default of 64, with a ledger: per bucket
    members, padded sizes, seconds, Gcell/s, request latency p50/p95/max
    and peak device memory; (2) per bucket the first packed batch rebuilt
    as the queue builds it (``pad_batch``, traced) with its field
    statistics equal to the command's lines, and two members rerun alone
    (B=1) bitwise equal to it; the same two through ``bind='baked'`` and
    solo ``HeatSolver3D`` (backend jnp), whose ``max_abs_err`` against the
    traced result should be 0.0; (3) every heat member of A and E at its
    budget against the fp64 golden on the card (rel < 1e-5 fp32, 5e-2
    bf16; the golden itself held to ``core.golden.step`` first), the two
    checked members of B (27pt tb=2, the superstep's per-member ghost
    rings) the same way, the C members against ``reference_varcoef_step``
    in fp64; (4) bucket A's
    first batch on a (2,2,2) spatial mesh and at ``batch_mesh=2`` (every
    shard on cuda:0), each bitwise equal to (1,1,1); (5) no hand-written
    kernel launched by (1)-(4), as on the JAX package's route; (6) ``serve
    --bench --members 64 --grid 128 --steps 50`` beside the solo
    ``--backend jnp`` and direct-kernel rows at 128^3 (no claim); (7)
    ``tune run --batch-members 16 --grid 128`` over tb 1/2: a ``jnp``
    winner under a ``b2^4`` key that an ``EnsembleSolver`` with
    ``time_blocking=0`` resolves through."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from heat3d_tpu_torch import cli, ops
    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.core.config import GridConfig, MeshConfig, SolverConfig
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.serve.cli import _base_from_record, _scenario_from_record
    from heat3d_tpu_torch.serve.ensemble import EnsembleSolver
    from heat3d_tpu_torch.serve.queue import DEFAULT_MAX_BATCH, _padded_size, pad_batch
    from heat3d_tpu_torch.serve.scenario import ScenarioBatch, request_bucket_key

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="heat3d_serve_")
    res = {}
    try:
        _check(os.environ.get("HEAT3D_SERVE_MAX_BATCH") is None,
               "serve: HEAT3D_SERVE_MAX_BATCH is set; the phase runs at its default")
        recs = _serve_records()
        path = os.path.join(root, "requests.jsonl")
        with open(path, "w") as f:
            for _, rec in recs:
                f.write(json.dumps(rec) + "\n")
        labels, groups = {}, {}
        for rid, (label, rec) in enumerate(recs):
            base, sc = _base_from_record(rec), _scenario_from_record(rec)
            labels[str(request_bucket_key(base, sc))] = label
            groups.setdefault(label, []).append((rid, base, sc))
        _check(sorted(set(labels.values())) == list(_SERVE_BUCKETS),
               f"serve: buckets {labels}")

        # (1) the command
        before = ops.launch_counts()
        led = os.path.join(root, "serve.jsonl")
        buf = io.StringIO()
        tc = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["serve", "--requests", path, "--residuals", "--ledger", led])
        cmd_s = time.perf_counter() - tc
        lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        _check(rc == 0 and [x["request_id"] for x in lines] == list(range(len(recs))),
               f"serve --requests: rc {rc}, {len(lines)} of {len(recs)} lines in order")
        for x, (_, rec) in zip(lines, recs):
            _check(x["steps"] == rec["steps"] and np.isfinite(x["field_mean"])
                   and np.isfinite(x["residual_sumsq"]), f"serve: line {x}")
        buckets = _bucket_summary(led, labels)
        for label in _SERVE_BUCKETS:
            want = [_padded_size(len(groups[label][i:i + DEFAULT_MAX_BATCH]),
                                 DEFAULT_MAX_BATCH, 1)
                    for i in range(0, len(groups[label]), DEFAULT_MAX_BATCH)]
            _check([b["padded"] for b in buckets[label]["batches"]] == want,
                   f"serve: bucket {label} batches {buckets[label]['batches']}")
            _say("serve_bucket", card=smi, bucket=label, **buckets[label])
        res["buckets"] = buckets

        # (2) packing, baked, solo; (3) goldens
        golden = {"self_check": _serve_golden_self_check()}
        a_first = None
        for label in _SERVE_BUCKETS:
            group = groups[label]
            chunks = [group[i:i + DEFAULT_MAX_BATCH]
                      for i in range(0, len(group), DEFAULT_MAX_BATCH)]
            worst_golden = 0.0
            for c, chunk in enumerate(chunks):
                base = chunk[0][1]
                members = [sc for _, _, sc in chunk]
                padded = _padded_size(len(members), DEFAULT_MAX_BATCH, 1)
                batch = pad_batch(base, members, padded)
                es = EnsembleSolver(batch, device="cuda:0")
                fields = es.gather(es.run(es.init_state()))[:len(members)]
                del es
                for i, (rid, _, _) in enumerate(chunk):
                    f64 = np.asarray(fields[i], np.float64)
                    _check(float(np.mean(f64)) == lines[rid]["field_mean"]
                           and float(np.max(f64)) == lines[rid]["field_max"],
                           f"serve: bucket {label} request {rid}: the rebuilt batch's "
                           f"statistics differ from the command's line")
                if label in ("A", "C", "E"):
                    worst_golden = max(worst_golden,
                                       _serve_golden(label, base, members, fields))
                if c:
                    continue
                if label == "A":
                    a_first = (base, members, fields)
                pick = (0, len(members) - 1)
                alone_ok = []
                for i in pick:
                    one = EnsembleSolver(ScenarioBatch(base, [members[i]]), device="cuda:0")
                    alone = one.gather(one.run(one.init_state()))[0]
                    _check(np.array_equal(alone, fields[i]),
                           f"serve: bucket {label} member {i} alone != packed "
                           f"(max {np.abs(alone - fields[i]).max()})")
                    alone_ok.append(True)
                two = ScenarioBatch(base, [members[i] for i in pick])
                if two.has_coef_fields:
                    baked = solo = "not run: coefficient fields need bind='traced'"
                else:
                    bk = EnsembleSolver(two, bind="baked", device="cuda:0")
                    got_b = bk.gather(bk.run(bk.init_state()))
                    baked = max(float(np.max(np.abs(got_b[j] - fields[i])))
                                for j, i in enumerate(pick))
                    solo = 0.0
                    for j, i in enumerate(pick):
                        s = HeatSolver3D(two.member_config(j), device="cuda:0")
                        got_s = s.gather(s.run(s.init_state(members[i].init),
                                               two.member_steps(j)))
                        solo = max(solo, float(np.max(np.abs(got_s - fields[i]))))
                    del bk, s
                if label == "B":
                    golden[label] = _serve_golden(label, base, [members[i] for i in pick],
                                                  [fields[i] for i in pick])
                    _say("serve_golden", card=smi, bucket=label, members=len(pick),
                         worst_rel_err=golden[label],
                         gate=_SERVE_GOLDEN_TOL[base.precision.storage])
                _say("serve_packing", card=smi, bucket=label, padded=padded,
                     members_checked=[chunk[i][0] for i in pick], alone_bitwise=alone_ok,
                     baked_max_abs_err=baked, solo_jnp_max_abs_err=solo,
                     expected_baked_and_solo=0.0)
                res.setdefault("packing", {})[label] = {"baked": baked, "solo": solo}
            if label in ("A", "C", "E"):
                golden[label] = worst_golden
                _say("serve_golden", card=smi, bucket=label, members=len(group),
                     worst_rel_err=worst_golden,
                     gate=_SERVE_GOLDEN_TOL[group[0][1].precision.storage])
            torch.cuda.empty_cache()
        res["golden"] = golden

        # (4) meshes on one card
        base, members, fields = a_first
        padded = _padded_size(len(members), DEFAULT_MAX_BATCH, 1)
        mesh = {}
        for what, shape, bm in (("mesh_222", (2, 2, 2), 1), ("batch_mesh_2", (1, 1, 1), 2)):
            cfg = dataclasses.replace(base, mesh=MeshConfig(shape=shape))
            tm = time.perf_counter()
            es = EnsembleSolver(pad_batch(cfg, members, padded), batch_mesh=bm,
                                device="cuda:0")
            got = es.gather(es.run(es.init_state()))[:len(members)]
            del es
            _check(np.array_equal(got, fields), f"serve: bucket A {what} != (1,1,1)")
            mesh[what] = {"bitwise": True, "seconds": time.perf_counter() - tm}
        _say("serve_mesh", card=smi, bucket="A", members=len(members), padded=padded, **mesh)
        res["mesh"] = mesh

        # (5) no hand-written kernel on the serving path
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        _check(not launched, f"serve: hand-written kernels launched: {launched}")
        _say("serve_launches", card=smi, kernel_launches={k: 0 for k in after},
             command_seconds=cmd_s)
        del a_first, fields
        torch.cuda.empty_cache()

        # (6) throughput beside the solo rows
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["serve", "--bench", "--members", "64", "--grid", "128",
                           "--steps", "50"])
        _check(rc == 0, f"serve --bench exited {rc}")
        row = json.loads(buf.getvalue().strip().splitlines()[-1])
        _check(row["members_per_step"] == 64 and not any(row["kernel_launches"].values()),
               f"serve --bench row: {row}")
        jnp_row = bench_throughput(SolverConfig(grid=GridConfig.cube(128), backend="jnp"),
                                   steps=50, warmup=1, repeats=3)
        direct_row = bench_throughput(SolverConfig(grid=GridConfig.cube(128)), steps=50,
                                      warmup=1, repeats=3)
        _check(direct_row["step_route"] == "direct", f"solo 128^3 route {direct_row}")
        res["bench"] = {"ensemble_gcell": row["gcell_per_sec"],
                        "per_member_gcell": row["gcell_per_sec"] / 64,
                        "solo_jnp_gcell": jnp_row["gcell_per_sec"],
                        "solo_direct_gcell": direct_row["gcell_per_sec"]}
        _say("serve_bench", card=smi, members=64, grid=[128] * 3, steps=row["steps"],
             seconds_best=row["seconds_best"], **res["bench"],
             ensemble_ms_per_step=row["seconds_best"] / row["steps"] * 1e3,
             solo_jnp_ms_per_step=jnp_row["seconds_best"] / jnp_row["steps"] * 1e3,
             solo_direct_ms_per_step=direct_row["seconds_best"] / direct_row["steps"] * 1e3,
             note="no claim: the ensemble runs the eager plain chain, as JAX's jnp route")
        del jnp_row, direct_row
        torch.cuda.empty_cache()

        # (7) the tuner's ensemble search and its resolution
        store = os.environ["HEAT3D_TUNE_CACHE"]
        rc, out = _tune_cmd(["run", "--batch-members", "16", "--grid", "128", "--mesh",
                             "1", "1", "1", "--knob", "time_blocking=1,2", "--steps", "20",
                             "--repeats", "2", "--probe-steps", "0", "--json"])
        _check(rc == 0, f"tune run --batch-members 16 exited {rc}: {out[-2000:]}")
        search = json.loads(out.strip().splitlines()[-1])
        from heat3d_tpu_torch.tune import cache as tcache

        entry = tcache.load(store)["entries"].get(search["key"])
        _check("|b2^4" in search["key"] and entry and entry["config"]["backend"] == "jnp",
               f"tune --batch-members 16: key {search['key']}, entry {entry}")
        from heat3d_tpu_torch.serve.scenario import Scenario

        auto = SolverConfig(grid=GridConfig.cube(128), time_blocking=0)
        es = EnsembleSolver(ScenarioBatch(auto, [Scenario(seed=m) for m in range(16)]))
        _check(es.cfg.time_blocking == entry["config"]["time_blocking"]
               and es.cfg.backend == "jnp",
               f"EnsembleSolver time_blocking=0 resolved to {es.cfg.time_blocking} "
               f"({es.cfg.backend}), entry {entry['config']}")
        del es
        res["tune"] = {"key": search["key"], "winner": search["winner"]}
        _say("serve_tune", card=smi, key=search["key"], trials=search["trials"],
             winner=search["winner"], resolved_time_blocking=entry["config"]["time_blocking"],
             elapsed_s=search["elapsed_s"])

    finally:
        shutil.rmtree(root, ignore_errors=True)
    _say("serve_path", card=smi, seconds=time.perf_counter() - t0)
    return res


# ---- serving, part two (the async engine, its warm-up, the soak, SLOs) ------

_ASYNC_A = 32  # bucket A's records in the async command, beside C, D and E


def _serve_async_records() -> list:
    """C, D and E of :func:`_serve_records` and the first 32 of A, in the
    order they have there."""
    recs, a = [], 0
    for label, rec in _serve_records():
        if label == "B" or (label == "A" and a >= _ASYNC_A):
            continue
        a += label == "A"
        recs.append((label, rec))
    return recs


def _soak_mix(duration_s: float = 30.0) -> dict:
    """The soak's seeded mix: ``tenant-a`` (weight 3) 128^3 7pt fp32, 100
    steps, four alphas and inits; ``flood`` (weight 1) 64^3 27pt tb=2, 50
    steps, a burst x8 for 2 s every 10 s; 6 Hz in all; max batch 8, 16
    open a stream, 2 workers."""
    inits = ("hot-cube", "gaussian", "random", "hot-cube")
    return {
        "duration_s": duration_s, "seed": 19, "rate_hz": 6.0,
        "engine": {"max_batch": 8, "max_per_stream": 16, "workers": 2},
        "monitor": {"interval_s": 0.5, "fast_window_s": 5, "slow_window_s": 15},
        "streams": [
            {"name": "tenant-a", "weight": 3, "scenarios": [
                {"grid": 128, "steps": 100, "alpha": alpha, "init": init, "seed": k}
                for k, (alpha, init) in enumerate(zip((0.3, 0.5, 0.7, 0.9), inits))]},
            {"name": "flood", "weight": 1,
             "burst": {"every_s": 10, "len_s": 2, "multiplier": 8},
             "scenarios": [{"grid": 64, "stencil": "27pt", "time_blocking": 2,
                            "steps": 50, "alpha": 0.4, "seed": 100}]},
        ],
    }


def _serve_cmd(argv) -> tuple:
    """``python -m heat3d_tpu_torch serve ARGV`` in this process: (rc, the
    JSON lines of its stdout, wall seconds)."""
    from heat3d_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["serve", *argv])
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    return rc, lines, time.perf_counter() - t0


def _ledger(path: str) -> list:
    return [json.loads(line) for line in open(path) if line.strip()]


def _batch_concurrency(spans: list) -> dict:
    """The batches' overlap from their ``serve_batch`` spans: the sum of
    their seconds over the seconds in which at least one ran (1.0: one at
    a time; 2.0: two workers always both busy)."""
    iv = sorted((e["ts"] - e["dur_s"], e["ts"]) for e in spans)
    union, end = 0.0, None
    for a, b in iv:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    busy = sum(b - a for a, b in iv)
    return {"batch_seconds": busy, "busy_window_s": union,
            "concurrency": busy / union if union else 0.0}


def phase_serve_async(smi: str) -> dict:
    """Serving part two on the card, in a temporary directory (the warm-up
    store namespace there too), every line with the card's name and power
    limit: (1) ``serve --requests --async --residuals --workers 2`` against
    the synchronous command over :func:`_serve_async_records`, every line
    equal but its queue latency; seconds per bucket, warm-up stall per
    bucket, the batches' concurrency, peak device memory; (2) the 30 s soak
    of :func:`_soak_mix` under ``--monitor`` with ``partial-device-loss`` at
    batch 3: verdict ``ok``, no stall after warmup, a requeue, degraded
    seconds, accounting and order kept, no burn alert; (3) the same mix
    under an impossible SLO with ``--abort-on-burn``: rc 1, ended early;
    (4) ``obs slo`` and ``obs watch --once`` over (2)'s ledger, rc 0; (5) no
    hand-written kernel launched by (1)-(4)."""
    import tempfile

    import torch

    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.obs.cli import main as obs_main
    from heat3d_tpu_torch.obs.perf import slo as slo_mod
    from heat3d_tpu_torch.serve import loadgen
    from heat3d_tpu_torch.serve.cli import _base_from_record, _scenario_from_record
    from heat3d_tpu_torch.serve.scenario import request_bucket_key, solver_bucket_key

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="heat3d_serve_async_")
    saved = {k: os.environ.pop(k, None) for k in ("HEAT3D_AOT_CACHE", "HEAT3D_FAULTS")}
    os.environ["HEAT3D_AOT_CACHE"] = os.path.join(root, "aot")
    before = ops.launch_counts()
    res = {}
    try:
        # (1) async against sync over the same records
        recs = _serve_async_records()
        path = os.path.join(root, "requests.jsonl")
        with open(path, "w") as f:
            for _, rec in recs:
                f.write(json.dumps(rec) + "\n")
        labels = {str(request_bucket_key(_base_from_record(r), _scenario_from_record(r))): lab
                  for lab, r in recs}
        runs = {}
        for mode, extra in (("sync", []), ("async", ["--async", "--workers", "2", "--verdict"])):
            led = os.path.join(root, f"{mode}.jsonl")
            torch.cuda.reset_peak_memory_stats()
            rc, lines, secs = _serve_cmd(["--requests", path, "--residuals", "--ledger", led,
                                          *extra])
            verdict = lines.pop()["serve_verdict"] if mode == "async" else None
            _check(rc == 0 and sorted(x["request_id"] for x in lines) == list(range(len(recs))),
                   f"serve --requests ({mode}): rc {rc}, {len(lines)} of {len(recs)} lines")
            evs = _ledger(led)
            spans = [e for e in evs if e.get("event") == "serve_batch" and e.get("kind") == "span"]
            stalls = [e for e in evs if e.get("event") == "compile_stall"]
            runs[mode] = {
                "lines": {x["request_id"]: x for x in lines}, "seconds": secs,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "verdict": verdict,
                "buckets": {lab: sum(e["dur_s"] for e in spans if e["bucket"] == key)
                            for key, lab in labels.items()},
                "stalls": {lab: sum(e["seconds"] for e in stalls if e["bucket"] == key)
                           for key, lab in labels.items()},
                "overlap": _batch_concurrency(spans),
            }
        for rid in range(len(recs)):
            a, b = runs["async"]["lines"][rid], runs["sync"]["lines"][rid]
            diff = sorted(k for k in set(a) | set(b)
                          if k != "queue_latency_s" and a.get(k) != b.get(k))
            _check(not diff, f"serve --async request {rid}: {diff} differ from sync: {a} {b}")
        eng = runs["async"]["verdict"]["engine"]
        _check(eng["aot"]["misses"] == len(labels) and eng["aot"]["stalls"] == len(labels)
               and eng["failed"] == 0,
               f"serve --async: warm-up {eng['aot']}, failed {eng['failed']}")
        res["requests"] = {
            "records": len(recs), "bitwise": True,
            "seconds": {m: runs[m]["seconds"] for m in runs},
            "per_bucket": {lab: {"sync_s": runs["sync"]["buckets"][lab],
                                 "async_s": runs["async"]["buckets"][lab],
                                 "warmup_stall_s": runs["async"]["stalls"][lab]}
                           for lab in sorted(set(labels.values()))},
            "overlap": runs["async"]["overlap"], "sync_overlap": runs["sync"]["overlap"],
            "peak_gib": {m: runs[m]["peak_gib"] for m in runs},
            "max_in_flight": eng["max_in_flight"],
        }
        _say("serve_async_requests", card=smi, **res["requests"])

        # (2) the soak, with a partial device loss at batch 3, monitored
        mix_path = os.path.join(root, "mix.json")
        with open(mix_path, "w") as f:
            json.dump(_soak_mix(), f)
        led = os.path.join(root, "soak.jsonl")
        row_path = os.path.join(root, "soak_row.jsonl")
        os.environ["HEAT3D_FAULTS"] = "partial-device-loss:batch=3:keep=1"
        try:
            rc, lines, secs = _serve_cmd(["--loadgen", mix_path, "--verdict", "--monitor",
                                          "--ledger", led, "--row", row_path])
        finally:
            os.environ.pop("HEAT3D_FAULTS", None)
        v = lines[-1]["soak_verdict"]
        _check(rc == 0 and v["ok"] and v["slo"] == "pass" and v["accounting_ok"]
               and v["order_ok"] and v["failed"] == 0 and v["compile_stall_after_warmup"] == 0
               and v["requeues"] >= 1 and v["degraded_s"] > 0 and not v["partial"]
               and v["monitor"]["alerts"] == 0,
               f"serve --loadgen: rc {rc}, verdict {v}")
        names = {str(solver_bucket_key(_base_from_record(st["scenarios"][0]))): st["name"]
                 for st in _soak_mix()["streams"]}
        row = json.loads(open(row_path).read().strip())
        res["soak"] = {
            "seconds": secs, "duration_s": v["duration_s"], "arrivals": v["arrivals"],
            "submitted": v["submitted"], "admitted": v["admitted"], "shed": v["shed"],
            "shed_by_stream": v["shed_by_stream"], "delivered": v["delivered"],
            "batches": v["batches"], "requeues": v["requeues"], "degraded_s": v["degraded_s"],
            "scale_events": v["scale_events"], "warmup_s": v["warmup_s"],
            "compile_stall_after_warmup": v["compile_stall_after_warmup"],
            "aot": v["aot"], "sustained_member_gcell_per_s": v["sustained_member_gcell_per_s"],
            "per_bucket": {names.get(k, k): pb for k, pb in v["per_bucket"].items()},
            "slo": v["slo"], "monitor_final": v["monitor"]["final"],
            "row_platform": row["platform"], "row_devices": row["devices"],
        }
        _say("serve_soak", card=smi, **res["soak"])

        # (3) an impossible SLO under --abort-on-burn ends the soak early
        mix = _soak_mix()
        mix["slo"] = {"objectives": [{"name": "impossible-p50", "kind": "serve_latency",
                                      "percentile": 50, "max_s": 1e-9}]}
        abort_path = os.path.join(root, "abort.json")
        with open(abort_path, "w") as f:
            json.dump(mix, f)
        abort_led = os.path.join(root, "abort.jsonl")
        rc, lines, secs = _serve_cmd(["--loadgen", abort_path, "--verdict", "--monitor",
                                      "--abort-on-burn", "--ledger", abort_led])
        va = lines[-1]["soak_verdict"]
        alerts = [e for e in _ledger(abort_led) if e.get("event") == "slo_burn_alert"]
        _check(rc == 1 and va["aborted"] and va["partial"] and va["abort_reason"] == "slo_burn"
               and va["duration_s"] < mix["duration_s"] and alerts,
               f"serve --loadgen --abort-on-burn: rc {rc}, verdict {va}")
        res["abort"] = {"rc": rc, "seconds": secs, "duration_s": va["duration_s"],
                        "submitted": va["submitted"], "arrivals": va["arrivals"],
                        "alerts": len(alerts)}
        _say("serve_soak_abort", card=smi, **res["abort"])

        # (4) obs slo and obs watch --once over the soak's ledger
        spec_path = os.path.join(root, "soak_slo.json")
        with open(spec_path, "w") as f:
            json.dump(loadgen.DEFAULT_SOAK_SLO, f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_slo = obs_main(["slo", led, "--spec", spec_path, "--json"])
        report = json.loads(buf.getvalue())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_watch = obs_main(["watch", led, "--once", "--spec", spec_path, "--json"])
        status = json.loads(buf.getvalue().strip().splitlines()[-1])
        degraded = [o for o in report["objectives"] if o["kind"] == "serve_degraded"]
        _check(rc_slo == 0 and report["verdict"] in ("pass", "warn") and rc_watch == 0
               and degraded and degraded[0]["status"] != "no_data"
               and status["burn"]["alerting"] == [],
               f"obs slo rc {rc_slo} {report['verdict']}; obs watch rc {rc_watch}")
        _check(slo_mod.load_spec(spec_path)["objectives"] == loadgen.DEFAULT_SOAK_SLO[
            "objectives"], "obs slo read another spec")
        res["obs"] = {"slo_rc": rc_slo, "slo_verdict": report["verdict"],
                      "watch_rc": rc_watch, "watch_events": status["events_seen"],
                      "degraded_value_s": degraded[0]["value"]}
        _say("serve_async_obs", card=smi, **res["obs"])

        # (5) no hand-written kernel on the serving path
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        _check(not launched, f"serve_async: hand-written kernels launched: {launched}")
        _say("serve_async_launches", card=smi, kernel_launches={k: 0 for k in after})
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        shutil.rmtree(root, ignore_errors=True)
    _say("serve_async_path", card=smi, seconds=time.perf_counter() - t0)
    return res


# the lint phase: each sanitizer child's bound (the four tools run at once)
_LINT_CHILD_S = 420


def _lint_rows(smi: str) -> dict:
    """The provenance lint and bench.report over the rows this run's bench
    calls wrote (``_BENCH_ROWS``): no defect, every row in the tables."""
    import tempfile

    from heat3d_tpu_torch.analysis import provenance
    from heat3d_tpu_torch.bench import report

    if not _BENCH_ROWS:
        _say("lint_rows", card=smi, rows=0, note="no bench phase ran")
        return {"rows": 0}
    with tempfile.TemporaryDirectory(prefix="heat3d_rows_") as d:
        path = os.path.join(d, "rows.jsonl")
        with open(path, "w") as f:
            for r in _BENCH_ROWS:
                f.write(json.dumps(r) + "\n")
        bad = provenance.check_file_findings(path)
        _check(not bad, f"provenance lint over this run's rows: {[b.message for b in bad][:5]}")
        loaded = report.load_results(path)
        table = report.render(loaded)
    _check(len(loaded) == len(_BENCH_ROWS), f"report read {len(loaded)} of "
           f"{len(_BENCH_ROWS)} rows")
    print(table, flush=True)
    kinds = {k: sum(r["bench"] == k for r in _BENCH_ROWS) for k in ("throughput", "halo")}
    _say("lint_rows", card=smi, rows=len(_BENCH_ROWS), **kinds, provenance_defects=0,
         report_lines=len(table.splitlines()))
    return {"rows": len(_BENCH_ROWS), **kinds}


def phase_lint(smi: str) -> dict:
    """``python -m heat3d_tpu_torch lint --all --json`` as a child on
    cuda:0: rc 0, no error, every judged case with each family's verdict,
    the seeded racy kernel flagged; the resources table and each tool's
    counts and seconds printed. Then the coverage and remote families at
    the main path's full-width shapes (no sanitizer) in this process, and
    the provenance lint and bench.report over this run's bench rows."""
    from collections import Counter

    import torch

    from heat3d_tpu_torch.analysis.kernel import KERNEL_CHECKERS, run_kernel_checkers
    from heat3d_tpu_torch.analysis.kernel.cases import judged_cases

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    env = dict(os.environ, HEAT3D_KERNEL_LINT_TIMEOUT_S=str(_LINT_CHILD_S),
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "heat3d_tpu_torch", "lint", "--all", "--json",
                          "--device", "cuda:0"], cwd=root, env=env, capture_output=True,
                         text=True, timeout=3 * _LINT_CHILD_S)
    child_s = time.perf_counter() - t0
    _check(out.returncode == 0, f"lint --all exited {out.returncode}: "
           f"{out.stdout[-3000:]} {out.stderr[-2000:]}")
    payload = json.loads(out.stdout)
    _check(payload["counts"]["error"] == 0, f"lint --all errors: {payload['findings']}")
    tier = payload["kernel_tier"]
    keys = [c.key for c in judged_cases()]
    multi = {c.key for c in judged_cases() if c.multi}
    _check(tier["cases"] == keys, f"judged cases {tier['cases']} != {keys}")
    for name in KERNEL_CHECKERS:
        want = multi if name == "kernel-remote" else set(keys)
        got = tier["verdicts"].get(name, {})
        _check(set(got) == want, f"{name}: verdicts for {sorted(got)} != {sorted(want)}")
    # the seeded racy kernel must be flagged wherever racecheck runs; where
    # the tool refuses the card, every racecheck verdict (the seeded one
    # too) is "not certified", and the line below says so
    seeded = tier.get("seeded", {})
    _check(seeded.get("flagged") is True
           or (seeded.get("certified") is False and "kernel-races" in tier.get("refused", {})),
           f"racecheck did not flag the seeded racy kernel: {seeded}")
    for name, words in tier.get("refused", {}).items():
        _say("lint_refused", card=smi, checker=name, sanitizer=tier.get("sanitizer"),
             words=words)
    for row in tier["resources"]:
        _say("lint_resources", card=smi, **{k: row[k] for k in (
            "family", "depth", "instance", "storage", "compute", "smem_bytes", "registers",
            "blocks_per_sm", "spill_stores", "spill_loads")}, cases=len(row["cases"]))
    uncertified = [f for f in payload["findings"] if f["code"] == "ANL1005"
                   and f["checker"] not in tier.get("refused", {})]
    for f in uncertified:
        _say("lint_not_certified", card=smi, checker=f["checker"], symbol=f["symbol"],
             message=f["message"][:400])
    _say("lint", card=smi, rc=out.returncode, counts=payload["counts"],
         suppressed=payload["suppressed"], cases=len(keys),
         verdicts={n: dict(Counter(v.values())) for n, v in tier["verdicts"].items()},
         seconds=tier["seconds"], children=tier.get("children"),
         seeded=tier["seeded"], smem_optin=tier.get("smem_optin"),
         sanitizer=tier.get("sanitizer"), child_seconds=child_s)
    # the main path's full-width shapes, without the sanitizer
    t1 = time.perf_counter()
    full: dict = {}
    found = run_kernel_checkers(root, ["kernel-coverage", "kernel-remote"], device="cuda:0",
                                scale="full", report=full)
    _check(not [f for f in found if f.severity == "error"],
           f"full-width coverage/remote: {[f.message for f in found]}")
    full_keys = {c.key for c in judged_cases("full")}
    _check(set(full["verdicts"]["kernel-coverage"]) == full_keys,
           f"full-width coverage ran {sorted(full['verdicts']['kernel-coverage'])}")
    _say("lint_full_width", card=smi, cases=sorted(full_keys),
         verdicts={n: dict(Counter(v.values())) for n, v in full["verdicts"].items()},
         seconds=full["seconds"], wall_s=time.perf_counter() - t1)
    torch.cuda.empty_cache()
    rows = _lint_rows(smi)
    _say("lint_path", card=smi, seconds=time.perf_counter() - t0)
    return {"counts": payload["counts"], "rows": rows}


# the phases after the build, in the order they run; ``--only`` picks some
PHASES = ("compare", "compare_mehrstellen", "compare_bf16", "compare_mesh", "compare_fused",
          "main_path", "families", "integrators", "state", "obs", "tune", "kernel_times",
          "mehrstellen_times",
          "compute_bf16_times", "dma_times", "halo_bench", "fused_times",
          "shard_kernel_times", "cross_gpu", "multiprocess", "serve", "serve_async", "lint")


def _args(argv):
    import argparse

    p = argparse.ArgumentParser(description="On-card smoke test of heat3d_tpu_torch.")
    p.add_argument("--only", default=None, metavar="PHASE[,PHASE...]",
                   help="run the card identification, the build and only these phases "
                        f"({', '.join(PHASES)}), and print no kernels line: a short "
                        "check after a kernel change")
    args = p.parse_args(argv)
    if args.only is not None:
        args.only = args.only.split(",")
        bad = sorted(set(args.only) - set(PHASES))
        if bad:
            p.error(f"unknown phases {bad}; choose from {', '.join(PHASES)}")
    return args


def main(argv=None) -> int:
    args = _args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    run = set(args.only or PHASES)
    # every phase resolves auto knobs against a store of this run's own
    # (empty but for what the tune phase writes), never the user's
    import atexit
    import tempfile

    store_dir = tempfile.mkdtemp(prefix="heat3d_store_")
    atexit.register(shutil.rmtree, store_dir, True)
    os.environ["HEAT3D_TUNE_CACHE"] = os.path.join(store_dir, "tune_cache.json")

    t0 = time.perf_counter()
    smi = phase_identify()
    bw = bandwidth(torch.cuda.get_device_name(0))
    resources = phase_build()
    worst = {name: 0.0 for name in KERNELS + tuple(_MEHR)}
    times = {}
    if "compare" in run:
        phase_compare(worst)
    if "compare_mehrstellen" in run:
        phase_compare_mehrstellen(worst)
    if "compare_bf16" in run:
        phase_compare_bf16(worst)
    if "compare_mesh" in run:
        phase_compare_mesh(worst)
    if "compare_fused" in run:
        phase_compare_fused(worst)
    if "main_path" in run:
        launches = phase_main_path(bw)
    if "families" in run:
        phase_families(bw, worst)
    if "integrators" in run:
        phase_integrators(bw)
    if "state" in run:
        phase_state(smi)
    if "obs" in run:
        phase_obs(smi, bw)
    if "tune" in run:
        phase_tune(smi, bw)
    if "kernel_times" in run:
        times.update(phase_kernel_times(bw, worst, resources))
    if "mehrstellen_times" in run:
        times.update(phase_mehrstellen_times(bw, worst, resources))
    if "compute_bf16_times" in run:
        bf16_times = phase_compute_bf16_times(bw, worst, resources)
    if "dma_times" in run:
        times["halo_dma"] = phase_dma_times(bw, worst)
    if "halo_bench" in run:
        phase_halo_bench(bw, worst)
    if "fused_times" in run:
        times.update(phase_fused_times(bw, worst, resources))
    if "shard_kernel_times" in run:
        phase_shard_kernel_times(bw, worst)
    if "cross_gpu" in run:
        phase_cross_gpu(worst)
    if "multiprocess" in run:
        phase_multiprocess(smi)
    if "serve" in run:
        phase_serve(smi)
    if "serve_async" in run:
        phase_serve_async(smi)
    if "lint" in run:
        phase_lint(smi)
    _say("done", seconds=time.perf_counter() - t0, phases=[p for p in PHASES if p in run])
    if args.only is None:
        kernels = [
            {"name": name, "route": "cuda", "source": _SOURCES[_MEHR.get(name, (name,))[0]],
             "replaces": _REPLACES[_MEHR.get(name, (name,))[0]], "launches": launches[name],
             "max_abs_err": worst[name],
             **{key: times[name][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             **({"compute_bf16_ms": bf16_times[name]["compute_bf16"]["ms"]}
                if name in COMPUTE_KERNELS else {}),
             **({"instance": times[name]["kernel"]} if "kernel" in times[name] else {}),
             **{key: times[name][key] for key in ("generic_ms", "generic_advection_ms")
                if key in times[name]}}
            for name in KERNELS + tuple(_MEHR)
        ]
        print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
