"""Opt-in per-link halo probe (``HEAT3D_COMM_PROBE``).

Port of ``heat3d_tpu.obs.comm.probe``. An exchange's phase ranges
(``heat3d.halo.<axis>``) attribute its time to an axis, but not to a
link. This probe measures each link directly: for every link the plan's
schedule exercises — one (axis, direction) pair per sharded mesh axis in
monolithic mode, one per sub-block in partitioned mode — it times a loop
of the port's own move of exactly that link's face sub-block, every
shard that has a neighbour that way moving its own, and emits one
``comm_probe`` ledger event per link carrying the schedule's predicted
bytes for that message, so every link reports predicted-vs-achieved GB/s
(``obs summary`` renders the table, ``obs.comm.report``).

The move is the transport's: on ``ppermute`` the slab ``copy_`` from the
shard's padded block into its neighbour's ghost slab (``parallel.halo``'s
copies, on the shard's stream); on ``dma`` the DMA push and wait launches
of that link alone (``ops.halo_dma.link_launches``; on the CPU their plain
version, the same copies). Where the JAX probe compiles a ``fori_loop`` of
one ``ppermute``, this one loops the move ``n`` times between a fork and a
join of the shard streams and times the loop: with CUDA events on one
card (no round trip in the number), else on the host clock between
synchronisations of every device, less the round trip. The trip count is
calibrated up until a loop lasts at least ``_FLOOR_S`` and 50 round trips,
so device time dwarfs the round trip; a row whose least raw loop time is
under twice the round trip carries ``rtt_dominated: true``, as bench rows
do.

``gbps`` is the JAX row's: one shard's message over the link's time. With
several shards on one card every sender's message shares it:
``senders`` counts them and ``gbps_senders`` is their bytes over the same
time. Links are timed in ISOLATION — the exchange orders and overlaps
them — so their sum bounds an exchange from above, not a reconstruction
of it.

Activation: ``HEAT3D_COMM_PROBE=1`` makes ``bench_halo`` run the probe
after its row (fail-soft — a probe failure never kills a bench);
``python -m heat3d_tpu_torch.obs.comm.probe`` runs it standalone (the CLI
is its own opt-in). ``HEAT3D_COMM_PROBE_ITERS`` overrides the timed-sample
count (default ``5``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import (
    BoundaryCondition,
    GridConfig,
    MeshConfig,
    SolverConfig,
)
from heat3d_tpu_torch.obs.metrics import percentile
from heat3d_tpu_torch.parallel.halo import axis_slab, padded_shape, part_dim, raw_slab
from heat3d_tpu_torch.parallel.plan import AXIS_NAMES, effective_halo_plan, make_schedule
from heat3d_tpu_torch.parallel.topology import build_shard_mesh
from heat3d_tpu_torch.utils.timing import calibrate_trip_count, cuda_time, sync_rtt

ENV_COMM_PROBE = "HEAT3D_COMM_PROBE"
ENV_COMM_PROBE_ITERS = "HEAT3D_COMM_PROBE_ITERS"
DEFAULT_ITERS = 5
# a timed loop lasts at least this long, and 50 round trips
_FLOOR_S = 0.02
_RTT_MULTIPLE = 50


def comm_probe_enabled() -> bool:
    """True when ``HEAT3D_COMM_PROBE`` opts the process into the per-link
    probe (``0``/empty/unset stay off — the probe adds timed loops, never
    free)."""
    return os.environ.get(ENV_COMM_PROBE, "") not in ("", "0")


def probe_iters(default: int = DEFAULT_ITERS) -> int:
    """Timed samples per link (``HEAT3D_COMM_PROBE_ITERS`` override;
    malformed values fall back — observability never raises over an env
    typo)."""
    raw = os.environ.get(ENV_COMM_PROBE_ITERS)
    if raw is None or raw == "":
        return default
    try:
        return max(1, int(raw))
    except ValueError:
        return default


def probe_links(schedule, local_shape, itemsize: int) -> List[Dict[str, Any]]:
    """The links ``schedule`` (a ``parallel.plan.Schedule``) exercises on a
    block of ``local_shape``, with the schedule's own predicted bytes per
    message.

    Mirrors :meth:`Schedule.traffic` exactly — the face extension of the
    axis ordering, the partition granularity floor — so the per-link
    ``bytes_predicted`` sum to its ``bytes_per_device``. Size-1 axes have
    no remote party and yield no links. Pure Python; the JAX function's
    links, without its ``perm`` (the port's neighbours come from the
    mesh), with the sub-block's ``part_dim`` and ``bounds``."""
    ext = list(local_shape)
    w = schedule.width
    links: List[Dict[str, Any]] = []
    for axis, size in enumerate(schedule.mesh_shape):
        name = AXIS_NAMES[axis]
        if size > 1:
            face_shape = [w if d == axis else ext[d] for d in range(3)]
            bounds = schedule.face_bounds(axis, face_shape, itemsize)
            pd = part_dim(axis)
            # "lo" = the transfer that fills my LOW ghost (the low
            # neighbour's high face, shifted up), as halo.<axis>.lo
            for direction in ("lo", "hi"):
                for i, (a, b) in enumerate(bounds):
                    sub = list(face_shape)
                    sub[pd] = b - a
                    sub_block = i if len(bounds) > 1 else None
                    scope = f"halo.{name}.{direction}" + (
                        f".p{i}" if sub_block is not None else ""
                    )
                    links.append(
                        {
                            "axis": axis,
                            "axis_name": name,
                            "direction": direction,
                            "sub_block": sub_block,
                            "sub_shape": tuple(sub),
                            "bytes_predicted": sub[0] * sub[1] * sub[2] * itemsize,
                            "scope": scope,
                            "part_dim": pd,
                            "bounds": (a, b),
                        }
                    )
        if schedule.halo_order == "axis":
            ext[axis] += 2 * w
    return links


def _link_copies(pads, mesh, link, width: int, periodic: bool, pairwise: bool):
    """(shard, ghost view, face view) of every shard that sends on
    ``link``: its face sub-block of its padded block and the matching
    ghost sub-block of its neighbour's (the slabs of
    ``parallel.halo.push_axis_slabs``, raw under pairwise ordering)."""
    axis, w = link["axis"], width
    local = mesh.local_shape
    n = local[axis]
    if link["direction"] == "lo":  # my high face -> high nb's low ghost
        step, face, ghost = +1, (n, n + w), (0, w)
    else:  # my low face -> low nb's high ghost
        step, face, ghost = -1, (w, 2 * w), (n + w, n + 2 * w)
    slab = raw_slab if pairwise else axis_slab
    pd, (a, b) = link["part_dim"], link["bounds"]
    copies = []
    for s in mesh.shards:
        nb = mesh.neighbor(s, axis, step, periodic)
        if nb is None:
            continue
        dst = pads[nb.rank][slab(axis, *ghost, local, w)].narrow(pd, a, b - a)
        src = pads[s.rank][slab(axis, *face, local, w)].narrow(pd, a, b - a)
        if tuple(dst.shape) != tuple(link["sub_shape"]):
            raise ValueError(f"link {link['scope']}: slab {tuple(dst.shape)} is not "
                             f"the schedule's {link['sub_shape']}")
        copies.append((s, dst, src))
    return copies


def _link_trip(cfg, mesh, pads, link, width, periodic, state):
    """One move of ``link`` on every sender: the DMA launches of that link
    (CUDA, ``halo='dma'``), else the slab copies, each on its shard's
    stream. Returns ``(trip, senders)``."""
    copies = _link_copies(pads, mesh, link, width, periodic, cfg.halo_order == "pairwise")
    if state is not None:
        from heat3d_tpu_torch.ops.halo_dma import link_launches, push_link_dma

        side = 0 if link["direction"] == "lo" else 1
        launches = link_launches(state, pads, link["axis"], side)
        dtype, bcv = pads[0].dtype, cfg.stencil.bc_value

        def trip() -> None:
            push_link_dma(state, launches, bcv, dtype)

        return trip, len(copies)

    def trip() -> None:
        for s, dst, src in copies:
            with mesh.on(s):
                dst.copy_(src)

    return trip, len(copies)


def probe_plan(
    cfg: SolverConfig,
    width: int = 1,
    iters: Optional[int] = None,
    warmup: int = 1,
    emit: bool = True,
    device=None,
) -> List[Dict[str, Any]]:
    """Time every link of ``cfg``'s effective exchange schedule with the
    shards placed on ``device`` (the solver's ``device=``); return (and by
    default ledger-emit) one ``comm_probe`` row per link.

    Row fields: link identity (``axis``/``axis_name``/``direction``/
    ``sub_block``/``scope``), plan provenance (``plan_key``, ``plan_mode``,
    ``width``, ``mesh``, ``halo``), the predicted message bytes
    (``bytes_predicted``), the per-trip p50 (``t_s``) and the ratio
    (``gbps``), the senders and their bytes' rate (``senders``,
    ``gbps_senders``, ``shards_per_device``), and the timing provenance
    (``iters``, ``trips``, ``sync_rtt_s``, ``rtt_dominated``,
    ``platform``). Empty list on a (1,1,1) mesh — no link exists."""
    it = probe_iters() if iters is None else max(1, int(iters))
    eff = effective_halo_plan(cfg)
    schedule = make_schedule(cfg.mesh.shape, width, eff, cfg.halo_order)
    dtype = getattr(torch, cfg.precision.storage)
    itemsize = torch.empty((), dtype=dtype).element_size()
    links = probe_links(schedule, cfg.local_shape, itemsize)
    if not links:
        return []
    mesh = build_shard_mesh(cfg, device)
    devices = sorted({s.device for s in mesh.shards}, key=str)
    cuda = devices[0].type == "cuda"
    events = cuda and len(devices) == 1
    periodic = cfg.stencil.bc is BoundaryCondition.PERIODIC
    want = padded_shape(mesh.local_shape, width)
    pads = [torch.zeros(want, dtype=dtype, device=s.device) for s in mesh.shards]
    state = None
    if cfg.halo == "dma" and cuda:
        from heat3d_tpu_torch.ops.halo_dma import DmaState

        state = DmaState(mesh, pads, width, periodic)
    rtt = sync_rtt(devices[0]) if cuda else 0.0
    floor = max(_FLOOR_S, _RTT_MULTIPLE * rtt)
    plan_key = (f"{'x'.join(map(str, cfg.mesh.shape))}/w{width}/{eff}/"
                f"{cfg.halo_order}/{cfg.halo}/{cfg.precision.storage}")
    ledger = obs.get()
    rows: List[Dict[str, Any]] = []
    for link in links:
        trip, senders = _link_trip(cfg, mesh, pads, link, width, periodic, state)

        def run(n: int, _trip=trip) -> None:
            mesh.fork()
            for _ in range(n):
                _trip()
            mesh.join()

        def timed(n: int, _run=run) -> float:
            if events:
                with torch.cuda.device(devices[0]):
                    return cuda_time(lambda: _run(n))
            t0 = time.perf_counter()
            _run(n)
            for d in devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            return time.perf_counter() - t0

        for _ in range(warmup):
            timed(1)
        trips, _ = calibrate_trip_count(timed, floor, start=25)
        raws = [timed(trips) for _ in range(it)]
        # CUDA events hold no round trip; the host clock does
        sub = 0.0 if events else rtt
        times = [max(t - sub, 0.0) / trips for t in raws]
        t50 = percentile(times, 50)
        nbytes = link["bytes_predicted"]
        row = {
            "axis": link["axis"],
            "axis_name": link["axis_name"],
            "direction": link["direction"],
            "sub_block": link["sub_block"],
            "scope": link["scope"],
            "width": width,
            "mesh": list(cfg.mesh.shape),
            "halo": cfg.halo,
            "plan_key": plan_key,
            "plan_mode": eff,
            "bytes_predicted": nbytes,
            "t_s": t50,
            "gbps": nbytes / t50 / 1e9 if t50 > 0 else None,
            "senders": senders,
            "gbps_senders": senders * nbytes / t50 / 1e9 if t50 > 0 else None,
            "shards_per_device": len(mesh) // len(devices),
            "iters": it,
            "trips": trips,
            "sync_rtt_s": rtt,
            "rtt_dominated": min(raws) < 2 * rtt,
            "platform": "gpu" if cuda else devices[0].type,
        }
        rows.append(row)
        if emit:
            ledger.event("comm_probe", **row)
    return rows


def maybe_probe(cfg: SolverConfig, width: int = 1, device=None) -> List[Dict[str, Any]]:
    """The env-gated hook ``bench_halo`` calls after its row: runs the
    probe iff ``HEAT3D_COMM_PROBE`` opts in, and fails SOFT — probe
    telemetry must never kill the bench that hosts it."""
    if not comm_probe_enabled():
        return []
    try:
        return probe_plan(cfg, width=width, device=device)
    except Exception as e:  # noqa: BLE001 - telemetry fails soft
        print(
            f"heat3d: comm probe failed ({type(e).__name__}: "
            f"{str(e)[:120]}); run continues unprobed",
            file=sys.stderr,
        )
        return []


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone probe CLI (``python -m heat3d_tpu_torch.obs.comm.probe``)
    — invoking it IS the opt-in, no env needed. Prints one JSON row per
    link (``--json``) or a readable table; ledger events go to
    ``--ledger`` / ``HEAT3D_LEDGER`` when configured."""
    ap = argparse.ArgumentParser(
        prog="heat3d-comm-probe",
        description="time every (axis, direction, sub-block) halo link "
        "of an exchange plan on its own",
    )
    ap.add_argument("--grid", type=int, nargs="+", default=[16],
                    help="global grid (1 value = cube, or 3)")
    ap.add_argument("--mesh", type=int, nargs="+", required=True,
                    help="mesh extents (1 value = slab, or 3)")
    ap.add_argument("--width", type=int, default=1, help="ghost width")
    ap.add_argument("--halo", default="ppermute", choices=("ppermute", "dma"),
                    help="the transport whose move each link times")
    ap.add_argument("--halo-plan", default="monolithic",
                    choices=("monolithic", "partitioned", "auto"))
    ap.add_argument("--halo-order", default="axis",
                    choices=("axis", "pairwise"))
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None,
                    help="torch device of every shard (cpu, cuda:0); "
                    "default shard i on cuda:i")
    ap.add_argument("--iters", type=int, default=None,
                    help=f"timed samples per link (default {DEFAULT_ITERS})")
    ap.add_argument("--json", dest="as_json", action="store_true",
                    help="one JSON row per link on stdout")
    ap.add_argument("--ledger", default=None,
                    help="ledger path (HEAT3D_LEDGER fallback)")
    args = ap.parse_args(argv)

    grid = args.grid if len(args.grid) == 3 else [args.grid[0]] * 3
    mesh = list(args.mesh) + [1] * (3 - len(args.mesh))
    cfg = SolverConfig(
        grid=GridConfig(shape=tuple(grid)),
        mesh=MeshConfig(shape=tuple(mesh[:3])),
        halo=args.halo,
        halo_plan=args.halo_plan,
        halo_order=args.halo_order,
    )
    cfg = dataclasses.replace(
        cfg, precision=dataclasses.replace(cfg.precision, storage=args.dtype)
    )
    obs.activate(args.ledger, meta={"entry": "comm_probe"})
    try:
        from heat3d_tpu_torch.tune.cache import resolve_config

        cfg = resolve_config(cfg, device=args.device)
        rows = probe_plan(cfg, width=args.width, iters=args.iters, device=args.device)
        if args.as_json:
            for row in rows:
                print(json.dumps(row))
        elif not rows:
            print("comm probe: no links (single-shard mesh)")
        else:
            for row in rows:
                blk = (
                    f".p{row['sub_block']}"
                    if row["sub_block"] is not None
                    else ""
                )
                flag = " (rtt-dominated)" if row["rtt_dominated"] else ""
                print(
                    f"{row['axis_name']}.{row['direction']}{blk}: "
                    f"{row['t_s'] * 1e6:.1f}us for "
                    f"{row['bytes_predicted']}B predicted -> "
                    f"{row['gbps']:.3f} GB/s{flag}"
                )
        return 0
    finally:
        obs.deactivate(rc=0)


if __name__ == "__main__":
    sys.exit(main())
