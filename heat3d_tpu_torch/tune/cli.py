"""``python -m heat3d_tpu_torch tune`` — the autotuner's operator surface.

Port of ``heat3d_tpu.tune.cli``, with its subcommands, flags, output lines
and JSON::

    tune run [--grid N] [--stencil 7pt] [--dtype fp32] [--mesh ..]
        [--device D] [--budget-s S] [--steps K] [--repeats R]
        [--knob name=v1,v2 ...] [--search-mesh] [--min-win PCT]
        [--cache PATH] [--no-cache-write] [--ledger PATH] [--json]
                                           # budgeted search, cache the winner
    tune show [--cache PATH] [--json]      # entries + speedup-vs-default
    tune apply [--key KEY | context flags] [--cache PATH]
                                           # emit the winning flag line
    tune clear [--key KEY | --all] [--cache PATH]
    tune lint [--cache PATH]               # schema lint (CI wiring)

``run`` executes a budgeted search over the knob lattice (``tune.space``)
through the search loop (``tune.measure``), prints the trial table
and the per-knob pairwise decisions (``tune.decide``), and writes the
winner into the tuning store (``tune.cache``) under this environment's
key. ``--device`` places every trial's shards (``cpu`` for the tests: the
kernels' plain versions on the host clock; ``cuda:0`` for a sharded search
on one card); without it they run on the card, shard i on ``cuda:i``.
``apply`` prints the winner as a solver/bench flag line. ``show`` marks an
entry of the JAX package (a shared store) ``jax``. ``--batch-members B``
above 1 searches the ensemble workload (B-member batches through
``serve.bench``, single-tenant routes pruned) and keys the winner, and
``apply``'s lookup, at the ``b2^k`` batch bucket.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from heat3d_tpu_torch.tune import cache as tcache


def _base_config(args):
    import dataclasses

    from heat3d_tpu_torch.cli import _default_mesh
    from heat3d_tpu_torch.core.config import (
        GridConfig,
        MeshConfig,
        Precision,
        RunConfig,
        SolverConfig,
        StencilConfig,
    )
    from heat3d_tpu_torch.eqn.cli import parse_eq_params

    grid = tuple(args.grid * 3 if len(args.grid) == 1 else args.grid)
    if len(grid) != 3:
        raise SystemExit("--grid takes 1 or 3 ints")
    if args.mesh is None:
        mesh = _default_mesh(args.device)
    elif len(args.mesh) == 1:
        mesh = MeshConfig.slab(args.mesh[0])
    elif len(args.mesh) == 3:
        mesh = MeshConfig(shape=tuple(args.mesh))
    else:
        raise SystemExit("--mesh takes 1 or 3 ints")
    prec = Precision.bf16() if args.dtype == "bf16" else Precision.fp32()
    cd = getattr(args, "compute_dtype", None)
    if cd:
        prec = dataclasses.replace(
            prec, compute="bfloat16" if cd == "bf16" else "float32"
        )
    return SolverConfig(
        grid=GridConfig(shape=grid),
        stencil=StencilConfig(kind=args.stencil),
        mesh=mesh,
        precision=prec,
        run=RunConfig(num_steps=getattr(args, "steps", 100)),
        # the search's static reference: the pre-tuner defaults
        backend="auto",
        halo="ppermute",
        overlap=False,
        time_blocking=1,
        halo_order="axis",
        halo_plan="monolithic",
        # equation context: keys the search/apply at the family's own
        # cache bucket (eqn.fingerprint leg)
        equation=getattr(args, "equation", "heat"),
        eq_params=parse_eq_params(getattr(args, "eq_param", [])),
    )


def _knob_space(args):
    from heat3d_tpu_torch.tune import space as tspace

    if args.knob:
        space = {}
        for spec in args.knob:
            if "=" not in spec:
                raise SystemExit(f"--knob wants name=v1,v2 — got {spec!r}")
            name, vals = spec.split("=", 1)
            name = name.strip()
            known = set(tspace.DEFAULT_KNOBS) | {"mesh"}
            if name not in known:
                raise SystemExit(
                    f"unknown knob {name!r} (have {sorted(known)})"
                )
            try:
                space[name] = tspace.parse_knob_values(name, vals)
            except ValueError as e:
                raise SystemExit(f"--knob {name}: {e}") from None
        return space
    space = dict(tspace.DEFAULT_KNOBS)
    if args.search_mesh:
        import torch

        n = 1 if args.device is not None else torch.cuda.device_count()
        space["mesh"] = tspace.mesh_candidates(n)
    return space


def _fmt_knobs(knobs) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(knobs.items()))


def cmd_run(args) -> int:
    from heat3d_tpu_torch import obs
    from heat3d_tpu_torch.tune import measure as tmeasure
    from heat3d_tpu_torch.tune.decide import format_decision

    obs.activate(args.ledger, meta={"entry": "tune"})
    try:
        base = _base_config(args)
        result = tmeasure.run_search(
            base,
            space=_knob_space(args),
            budget_s=args.budget_s,
            steps=args.steps,
            repeats=args.repeats,
            probe_steps=args.probe_steps,
            min_win_pct=args.min_win,
            write_cache=not args.no_cache_write,
            cache_path=args.cache,
            batch_members=args.batch_members,
            device=args.device,
        )
    except BaseException as e:
        obs.deactivate(rc=1, error=f"{type(e).__name__}: {str(e)[:200]}")
        raise
    if args.json:
        # where the trials ran: a CPU search must never pass for a card's
        platform = "gpu" if tmeasure._on_card(args.device) else "cpu"
        print(
            json.dumps(
                {
                    "key": result.key,
                    "platform": platform,
                    "elapsed_s": result.elapsed_s,
                    "budget_s": result.budget_s,
                    "enumerate_s": result.enumerate_s,
                    "winner": (
                        None
                        if result.winner is None
                        else {
                            "knobs": result.winner.knobs,
                            "gcell_per_sec_per_chip": result.winner.metric,
                        }
                    ),
                    "speedup_vs_default": result.speedup_vs_default,
                    "cache_written": result.cache_written,
                    "trials": [
                        {
                            "knobs": t.knobs,
                            "status": t.status,
                            "reason": t.reason,
                            "gcell_per_sec_per_chip": t.metric,
                        }
                        for t in result.trials
                    ],
                    "decisions": result.decisions,
                }
            )
        )
    else:
        print(f"tune run: key {result.key}")
        for t in result.trials:
            m = f"{t.metric:9.4g}" if t.metric is not None else "        -"
            extra = f"  ({t.reason})" if t.reason else ""
            print(f"  {t.status:<9} {m}  {_fmt_knobs(t.knobs)}{extra}")
        for d in result.decisions:
            print("  " + format_decision(d))
        if result.winner is None:
            print("tune run: no measurable winner (all candidates pruned/"
                  "errored/RTT-dominated)", file=sys.stderr)
        else:
            sp = result.speedup_vs_default
            sp_s = f" ({sp:.2f}x vs default)" if sp else ""
            print(
                f"winner: {_fmt_knobs(result.winner.knobs)} -> "
                f"{result.winner.metric:.4g} Gcell/s/chip{sp_s}"
            )
            if result.cache_written:
                print(f"cached: {result.cache_written}")
        print(f"elapsed: {result.elapsed_s:.1f}s"
              + (f" (budget {result.budget_s:.0f}s)" if result.budget_s else ""))
    rc = 0 if result.winner is not None else 1
    obs.deactivate(rc=rc)
    return rc


def _entry_lines(key: str, e: dict) -> str:
    cfg = e.get("config") or {}
    prov = e.get("provenance") or {}
    metric = e.get("gcell_per_sec_per_chip")
    default = e.get("default_gcell_per_sec_per_chip")
    speed = (
        f"{metric / default:.2f}x vs default"
        if isinstance(metric, (int, float))
        and isinstance(default, (int, float))
        and default > 0
        else "speedup n/a"
    )
    tb = cfg.get("time_blocking")
    if isinstance(tb, int) and tb > 1:
        # temporal-blocking winners: k-fold fewer exchanges, paid in
        # ghost-ring recompute (the measured metric already includes it)
        speed += f"; tb={tb} winner ({tb}x fewer exchanges, ring recompute"
        speed += " priced in)"
    if cfg.get("halo_plan") == "partitioned":
        speed += "; partitioned-exchange winner (early-bird sub-block sends)"
    if "|b2^" in key:
        speed += "; batch-bucket winner (ensemble workload)"
    fam = cfg.get("equation") or _key_equation(key)
    if fam != "heat":
        speed += f"; equation={fam}"
    if tcache.is_jax_entry(e):
        # the JAX package's entry in a shared store: stale for the port
        measured = (f"measured: {prov.get('ts')} jax={prov.get('jax_version')} "
                    f"run={prov.get('run_id')} [jax]")
    else:
        measured = (f"measured: {prov.get('ts')} torch={prov.get('torch_version')} "
                    f"kernels={prov.get('kernels')} run={prov.get('run_id')}")
    return (
        f"{key}\n"
        f"    config: {_fmt_knobs(cfg)}\n"
        f"    {metric} Gcell/s/chip ({speed})\n"
        f"    {measured}"
    )


def _key_equation(key: str) -> str:
    """The equation family a cache key's fingerprint leg names — 'heat'
    for a bare stencil-kind leg, else the family half of
    ``family:kind:spec-hash`` (eqn.fingerprint)."""
    parts = key.split("|")
    if len(parts) < 6:
        return "heat"
    leg = parts[4]
    return leg.split(":", 1)[0] if ":" in leg else "heat"


def cmd_show(args) -> int:
    doc = tcache.load(args.cache)
    entries = doc.get("entries") or {}
    peaks = doc.get("peaks") or {}
    if args.json:
        print(json.dumps(doc))
        return 0
    path = tcache.cache_path(args.cache)
    if not entries and not peaks:
        print(f"tune cache {path}: empty (run `python -m heat3d_tpu_torch tune run`)")
        return 0
    print(f"tune cache {path}: {len(entries)} entr"
          f"{'y' if len(entries) == 1 else 'ies'}")
    for key in sorted(entries):
        print("  " + _entry_lines(key, entries[key]).replace("\n", "\n  "))
    for chip in sorted(peaks):
        rec = peaks[chip]
        prov = rec.get("provenance") or {}
        print(
            f"  peak {chip}: {rec.get('vector_gflops')} GFLOP/s "
            f"(calibrated {prov.get('ts')})"
        )
    return 0


def _context_key(args) -> str:
    return tcache.cache_key(
        _base_config(args),
        batch_size=getattr(args, "batch_members", 1) or 1,
        device=args.device,
    )


def cmd_apply(args) -> int:
    entries = tcache.load(args.cache).get("entries") or {}
    key = args.key or _context_key(args)
    e = entries.get(key)
    if not isinstance(e, dict):
        print(
            f"tune apply: no cache entry for key {key!r} "
            f"(have: {sorted(entries) or 'none'})",
            file=sys.stderr,
        )
        return 1
    cfg = e.get("config") or {}
    parts: List[str] = []
    if cfg.get("backend"):
        parts += ["--backend", str(cfg["backend"])]
    if cfg.get("halo"):
        parts += ["--halo", str(cfg["halo"])]
    if cfg.get("time_blocking") is not None:
        parts += ["--time-blocking", str(cfg["time_blocking"])]
    if cfg.get("halo_order") and cfg["halo_order"] != "axis":
        parts += ["--halo-order", str(cfg["halo_order"])]
    if cfg.get("halo_plan") and cfg["halo_plan"] != "monolithic":
        parts += ["--halo-plan", str(cfg["halo_plan"])]
    if cfg.get("overlap"):
        parts.append("--overlap")
    if cfg.get("mesh"):
        parts += ["--mesh"] + [str(x) for x in cfg["mesh"]]
    # equation context: the entry persists the measured workload's family
    # and exact eq_params, emitted at full repr precision (the fingerprint
    # hashes them; a rounded value would address a different bucket)
    fam = cfg.get("equation") or _key_equation(key)
    if fam != "heat":
        parts += ["--equation", str(fam)]
        for name, value in cfg.get("eq_params") or []:
            parts += ["--eq-param", f"{name}={value!r}"]
    print(" ".join(parts))
    return 0


def cmd_clear(args) -> int:
    path = tcache.cache_path(args.cache)
    if args.all:
        import os

        if os.path.exists(path):
            os.unlink(path)
            print(f"tune clear: removed {path}")
        else:
            print(f"tune clear: {path} absent, nothing to do")
        return 0
    if not args.key:
        print("tune clear: need --key KEY or --all", file=sys.stderr)
        return 2
    doc = dict(tcache.load(args.cache))
    entries = dict(doc.get("entries") or {})
    if args.key not in entries:
        print(f"tune clear: no entry {args.key!r}", file=sys.stderr)
        return 1
    del entries[args.key]
    doc["entries"] = entries
    tcache._save(doc, args.cache)
    print(f"tune clear: removed entry {args.key!r}")
    return 0


def cmd_lint(args) -> int:
    path = tcache.cache_path(args.cache)
    bad = tcache.lint(args.cache)
    if not bad:
        print(f"tune cache ok: {path}")
        return 0
    print(f"tune cache FAIL: {path}: {len(bad)} defect(s)", file=sys.stderr)
    for b in bad:
        print(f"  {b}", file=sys.stderr)
    return 1


def _add_context_args(p) -> None:
    p.add_argument("--grid", type=int, nargs="+", default=[32],
                   help="global grid: one int (cube) or three")
    p.add_argument("--stencil", choices=["7pt", "27pt"], default="7pt")
    p.add_argument("--equation", default="heat",
                   help="equation family context (eqn list): keys the "
                   "search/apply at the family's own cache bucket")
    p.add_argument("--eq-param", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="equation parameter override (repeatable) — part "
                   "of the cache-key fingerprint for non-heat families")
    p.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32")
    p.add_argument("--compute-dtype", choices=["fp32", "bf16"], default=None,
                   help="stencil-math dtype override (default: the "
                   "storage policy's — fp32 either way)")
    p.add_argument("--mesh", type=int, nargs="+", default=None,
                   help="mesh of shards Px Py Pz (default: every visible "
                   "GPU, balanced 3D; 1 1 1 under --device)")
    p.add_argument("--device", default=None,
                   help="torch device of every shard, as the solver's "
                   "--device (cpu: the kernels' plain versions; cuda:0: "
                   "every shard on one card, the key's s leg); default "
                   "shard i on cuda:i")
    p.add_argument("--batch-members", type=int, default=1,
                   help="search the ENSEMBLE workload (B-member batches) "
                   "instead of solo: trials run serve/bench batches, single-"
                   "tenant routes are pruned, and the winner lands at (and "
                   "apply looks up) the b2^k batch-bucketed cache key the "
                   "serving queue's bucket solvers resolve through")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="heat3d_tpu_torch tune",
        description="searched, cached, ledger-audited config selection",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="budgeted search; cache the winner")
    _add_context_args(r)
    r.add_argument("--steps", type=int, default=30,
                   help="full-measurement step floor per trial")
    r.add_argument("--repeats", type=int, default=2,
                   help="timed repeats per full measurement")
    r.add_argument("--probe-steps", type=int, default=8,
                   help="short-probe step floor for domination pruning "
                   "(0 disables probing)")
    r.add_argument("--budget-s", type=float, default=None,
                   help="wall-clock budget; the static default is always "
                   "measured, remaining candidates stop when it runs out")
    r.add_argument("--knob", action="append", default=None,
                   metavar="NAME=V1,V2",
                   help="restrict the search space to these knob values "
                   "(repeatable); default: the full lattice")
    r.add_argument("--search-mesh", action="store_true",
                   help="add mesh-factorization candidates for the "
                   "visible device count to the space")
    r.add_argument("--min-win", type=float, default=5.0,
                   help="speedup %% below which a pairwise call is "
                   "'keep default'")
    r.add_argument("--cache", default=None,
                   help="tuning-cache path (default $HEAT3D_TUNE_CACHE or "
                   "~/.cache/heat3d/tune_cache.json)")
    r.add_argument("--no-cache-write", action="store_true",
                   help="search + report only; leave the cache untouched")
    r.add_argument("--ledger", default=None,
                   help="run ledger path (default $HEAT3D_LEDGER)")
    r.add_argument("--json", action="store_true")
    r.set_defaults(fn=cmd_run)

    s = sub.add_parser("show", help="print the cache with per-entry "
                       "speedup-vs-default")
    s.add_argument("--cache", default=None)
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_show)

    a = sub.add_parser("apply", help="emit the cached winner as a flag line")
    _add_context_args(a)
    a.add_argument("--key", default=None,
                   help="exact cache key (default: derived from the "
                   "context flags in this environment)")
    a.add_argument("--cache", default=None)
    a.set_defaults(fn=cmd_apply)

    c = sub.add_parser("clear", help="drop one entry (or the whole store)")
    c.add_argument("--key", default=None)
    c.add_argument("--all", action="store_true")
    c.add_argument("--cache", default=None)
    c.set_defaults(fn=cmd_clear)

    ln = sub.add_parser("lint", help="cache schema lint (CI wiring)")
    ln.add_argument("--cache", default=None)
    ln.set_defaults(fn=cmd_lint)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
