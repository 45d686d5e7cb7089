"""The port's source checkers and finding framework against the JAX
package's (tier-1, CPU).

- The framework: the same fields give the same fingerprint in both
  packages; a baseline the JAX package writes reads back equal through
  the port's loader; the suppression and rc policy of
  ``tests/test_analysis.py``, on the port's copy.
- The checkers: each seeded-hazard fixture of ``tests/test_analysis.py``
  rewritten in the port's vocabulary (``torch.distributed``, the
  port's wrappers) fires the same code at the same line as the JAX
  checker over the JAX-vocabulary twin, and the uniform-guard twins stay
  quiet in both.
- Provenance: the same rows give identical findings from both
  ``check_row``s.
- The port is lint-clean: ``python -m heat3d_tpu_torch lint --json`` in a
  JAX-free child exits 0 with no error and lists the full catalog.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from heat3d_tpu.analysis import collectives as ref_collectives
from heat3d_tpu.analysis import eqnlint as ref_eqnlint
from heat3d_tpu.analysis import failsoft as ref_failsoft
from heat3d_tpu.analysis import findings as ref_findings
from heat3d_tpu.analysis import knobs as ref_knobs
from heat3d_tpu.analysis import provenance as ref_provenance
from heat3d_tpu.analysis import taxonomy as ref_taxonomy
from heat3d_tpu.analysis import astutil as ref_astutil
from heat3d_tpu_torch.analysis import CHECKERS, astutil, collectives, eqnlint, failsoft
from heat3d_tpu_torch.analysis import findings, knobs, provenance, taxonomy
from heat3d_tpu_torch.analysis.cli import main as lint_main
from heat3d_tpu_torch.analysis.cli import run_checkers
from heat3d_tpu_torch.analysis.findings import (
    ERROR,
    WARNING,
    Finding,
    apply_suppressions,
    exit_code,
    load_baseline,
    write_baseline,
)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@pytest.fixture(autouse=True)
def _fresh_ast_cache():
    """Fixture files are rewritten across tests under tmp paths; a stale
    parse cache would cross-contaminate them."""
    astutil.clear_cache()
    ref_astutil.clear_cache()
    yield
    astutil.clear_cache()
    ref_astutil.clear_cache()


def _write(tmp_path, relpath, source):
    path = tmp_path / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return str(path)


def _sites(found):
    return sorted((f.code, f.line, f.symbol) for f in found)


# ---- the framework ---------------------------------------------------------


_FIELDS = [
    dict(checker="collective-divergence", severity="error", path="pkg/a.py", line=7,
         code="ANL101", message="collective 'x' guarded at line 12", symbol="f"),
    dict(checker="knob-drift", severity="error", path="heat3d_tpu_torch/tune/space.py",
         line=0, code="ANL503", message="config knob 'halo' absent", symbol="halo"),
    dict(checker="c", severity="warning", path="p.py", line=3, code="X",
         message="budget 12 MiB over 16 MiB cap", symbol=None),
    dict(checker="kernel-coverage", severity="info", path="k.py", line=0,
         code="ANL1021", message="m 1 2 3", symbol="direct1-7pt|ANL1021"),
]


@pytest.mark.parametrize("fields", _FIELDS, ids=lambda f: f["code"])
def test_fingerprints_equal_jax(fields):
    mine, ref = Finding(**fields), ref_findings.Finding(**fields)
    assert mine.fingerprint() == ref.fingerprint()
    assert mine.to_dict() == ref.to_dict()
    moved = Finding(**{**fields, "line": fields["line"] + 40})
    assert moved.fingerprint() == mine.fingerprint()


def test_jax_baseline_reads_back_equal(tmp_path):
    path = str(tmp_path / "b.json")
    ref_findings.write_baseline(path, [ref_findings.Finding(**f) for f in _FIELDS])
    assert load_baseline(path) == ref_findings.load_baseline(path)
    assert len(load_baseline(path)) == len(_FIELDS)
    # and the other way round
    path2 = str(tmp_path / "b2.json")
    write_baseline(path2, [Finding(**f) for f in _FIELDS])
    with open(path) as a, open(path2) as b:
        assert json.load(a) == json.load(b)


def test_baseline_name_is_the_ports_own():
    assert findings.BASELINE_NAME != ref_findings.BASELINE_NAME
    assert not os.path.exists(os.path.join(REPO, findings.BASELINE_NAME))


def _finding(line=7, message="collective 'dist.all_reduce' is guarded"):
    return Finding(
        checker="collective-divergence",
        severity=ERROR,
        path="pkg/bad_coll.py",
        line=line,
        code="ANL101",
        symbol="process_guarded",
        message=message,
    )


def test_inline_ok_comment_suppresses_only_named_checker(tmp_path):
    path = _write(tmp_path, "pkg/bad_coll.py", "x = 1\n")
    lines = ["# pad\n"] * 10
    lines[6] = "    dist.all_reduce(u)  # heat3d-lint: ok=collective-divergence reason\n"
    with open(path, "w") as f:
        f.writelines(lines)
    kept, suppressed = apply_suppressions(str(tmp_path), [_finding(line=7)], {})
    assert kept == [] and len(suppressed) == 1
    other = Finding(checker="fail-soft", severity=ERROR, path="pkg/bad_coll.py",
                    line=7, code="ANL201", message="m")
    kept, suppressed = apply_suppressions(str(tmp_path), [other], {})
    assert kept == [other]


def test_baseline_round_trip_suppresses_grandfathered(tmp_path):
    baseline_path = str(tmp_path / findings.BASELINE_NAME)
    f_old = _finding()
    assert write_baseline(baseline_path, [f_old]) == 1
    baseline = load_baseline(baseline_path)
    kept, suppressed = apply_suppressions(str(tmp_path), [f_old], baseline)
    assert kept == [] and suppressed == [f_old]
    f_new = Finding(checker=f_old.checker, severity=ERROR, path=f_old.path, line=3,
                    code=f_old.code, symbol="fresh_function", message="m")
    kept, _ = apply_suppressions(str(tmp_path), [f_new], baseline)
    assert kept == [f_new]


def test_broken_baseline_hides_nothing(tmp_path):
    p = tmp_path / "b.json"
    p.write_text("{not json")
    assert load_baseline(str(p)) == {}


def test_rc_policy_errors_only():
    warn = Finding(checker="c", severity=WARNING, path="p", line=0, code="X", message="m")
    assert exit_code([warn]) == 0
    assert exit_code([warn, _finding()]) == 1
    assert exit_code([]) == 0


def test_crashed_checker_is_an_error_finding(monkeypatch):
    monkeypatch.setitem(CHECKERS, "knob-drift", "heat3d_tpu_torch.analysis.astutil")
    found = run_checkers(REPO, ["knob-drift"])
    assert [f.code for f in found] == ["ANL000"] and found[0].severity == ERROR
    monkeypatch.setitem(CHECKERS, "knob-drift", "heat3d_tpu_torch.analysis.gone")
    assert [f.code for f in run_checkers(REPO, ["knob-drift"])] == ["ANL000"]


def test_write_baseline_keeps_still_firing_and_never_grandfathers_crashes(
        tmp_path, capsys, monkeypatch):
    _write(tmp_path, "heat3d_tpu_torch/bad.py", PORT_BAD_COLLECTIVES)
    baseline = str(tmp_path / findings.BASELINE_NAME)
    args = ["--checker", "collective-divergence", "--root", str(tmp_path),
            "--baseline", baseline]
    assert lint_main(args + ["--json"]) == 1
    capsys.readouterr()
    assert lint_main(args + ["--write-baseline"]) == 0
    assert lint_main(args + ["--write-baseline"]) == 0
    capsys.readouterr()
    assert lint_main(args + ["--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["counts"]["error"] == 0 and payload["suppressed"] > 0
    assert lint_main(args + ["--no-suppress"]) == 1
    capsys.readouterr()
    # another checker's regeneration keeps these entries
    assert lint_main(["--checker", "fail-soft", "--root", str(tmp_path),
                      "--baseline", baseline, "--write-baseline"]) == 0
    capsys.readouterr()
    assert any(e["checker"] == "collective-divergence"
               for e in load_baseline(baseline).values())
    # a crash is never grandfathered
    crash_base = str(tmp_path / "crash.json")
    monkeypatch.setitem(CHECKERS, "collective-divergence",
                        "heat3d_tpu_torch.analysis.astutil")
    cargs = ["--checker", "collective-divergence", "--root", str(tmp_path),
             "--baseline", crash_base]
    assert lint_main(cargs + ["--write-baseline"]) == 0
    capsys.readouterr()
    assert load_baseline(crash_base) == {}
    assert lint_main(cargs) == 1
    capsys.readouterr()


def test_lint_cli_unknown_checker_rejected():
    with pytest.raises(SystemExit):
        lint_main(["--checker", "no-such-checker"])


def test_lint_cli_ir_tier_has_no_counterpart(capsys):
    assert lint_main(["--ir"]) == 2
    assert "no traced programs" in capsys.readouterr().err


def test_lint_cli_list_names_both_tiers(capsys):
    assert lint_main(["--all", "--list"]) == 0
    out = capsys.readouterr().out
    for name in ("collective-divergence", "fail-soft", "ledger-taxonomy", "knob-drift",
                 "eqn-registry", "kernel-memcheck", "kernel-races", "kernel-sync",
                 "kernel-init", "kernel-coverage", "kernel-remote", "kernel-resources"):
        assert f"{name}:" in out


# ---- collective-divergence -------------------------------------------------
# the JAX fixtures of tests/test_analysis.py and their port twins, line for
# line

REF_BAD_COLLECTIVES = """
    import jax
    import jax.numpy as jnp
    from jax import lax

    def process_guarded(u):
        if jax.process_index() == 0:
            u = lax.ppermute(u, "x", [(0, 1)])
        return u

    def taint_guarded(u):
        pid = jax.process_index()
        if pid == 0:
            u = lax.psum(u, "x")
        return u

    def device_guarded(u):
        idx = lax.axis_index("x")
        if idx == 0:
            u = lax.psum(u, "x")
        return u

    def data_guarded(u, thresh):
        if float(jnp.max(u)) > thresh:
            u = lax.psum(u, "x")
        return u

    def wraps_collective(u):
        return lax.ppermute(u, "x", [(0, 1)])

    def indirect_guarded(u):
        if jax.process_index() == 0:
            u = wraps_collective(u)
        return u
"""

PORT_BAD_COLLECTIVES = """
    from heat3d_tpu_torch.parallel import distributed
    import torch
    import torch.distributed as dist

    def process_guarded(u):
        if distributed.process_index() == 0:
            u = dist.all_reduce(u)
        return u

    def taint_guarded(u):
        pid = dist.get_rank()
        if pid == 0:
            u = distributed.barrier()
        return u

    def device_guarded(u):
        idx = torch.cuda.current_device()
        if idx == 0:
            u = dist.all_reduce(u)
        return u

    def data_guarded(u, thresh):
        if float(torch.max(u)) > thresh:
            u = dist.all_reduce(u)
        return u

    def wraps_collective(u):
        return distributed.all_gather_object(u)

    def indirect_guarded(u):
        if distributed.is_coordinator():
            u = wraps_collective(u)
        return u
"""

REF_GOOD_COLLECTIVES = """
    from jax import lax

    def uniform_guard(u, periodic):
        if periodic:
            u = lax.ppermute(u, "x", [(0, 1)])
        return u

    def unguarded(u):
        return lax.psum(u, "x")

    def no_collective(u):
        if float(u.sum()) > 0:
            return u * 2
        return u
"""

PORT_GOOD_COLLECTIVES = """
    import torch.distributed as dist

    def uniform_guard(u, periodic):
        if periodic:
            u = dist.all_reduce(u)
        return u

    def unguarded(u):
        return dist.barrier()

    def no_collective(u):
        if float(u.sum()) > 0:
            return u * 2
        return u
"""


def test_collective_divergence_fires_as_jax(tmp_path):
    ref = _write(tmp_path, "jaxpkg/bad_coll.py", REF_BAD_COLLECTIVES)
    mine = _write(tmp_path, "portpkg/bad_coll.py", PORT_BAD_COLLECTIVES)
    want = ref_collectives.check(str(tmp_path), files=[ref])
    got = collectives.check(str(tmp_path), files=[mine])
    assert _sites(got) == _sites(want)
    by_sym = {f.symbol: f for f in got}
    assert by_sym["process_guarded"].code == "ANL101"
    assert by_sym["taint_guarded"].code == "ANL101"
    assert by_sym["device_guarded"].code == "ANL102"
    assert by_sym["data_guarded"].code == "ANL103"
    assert by_sym["indirect_guarded"].code == "ANL101"
    assert "collective-bearing" in by_sym["indirect_guarded"].message
    assert "wraps_collective" not in by_sym
    assert all(f.severity == ERROR for f in got)


def test_collective_divergence_quiet_on_uniform_guards_as_jax(tmp_path):
    ref = _write(tmp_path, "jaxpkg/good_coll.py", REF_GOOD_COLLECTIVES)
    mine = _write(tmp_path, "portpkg/good_coll.py", PORT_GOOD_COLLECTIVES)
    assert ref_collectives.check(str(tmp_path), files=[ref]) == []
    assert collectives.check(str(tmp_path), files=[mine]) == []


PORT_ONLY_BAD = """
    import os
    import torch
    from heat3d_tpu_torch.ops import peer
    from heat3d_tpu_torch.parallel import distributed

    def slot_guarded(shard, word):
        if shard.slot == 0:
            peer.wait(word, 1)

    def item_guarded(res, u):
        if res.item() > 1.0:
            distributed.broadcast_object(u)

    def env_guarded(plan, us):
        if os.environ.get("HEAT3D_PROCESS_ID") == "0":
            plan.wire.flush()

    def deep(us, mesh, state):
        return apply_superstep_fused_dma(us, None, mesh, state)

    def deeper(us, mesh, state):
        return deep(us, mesh, state)

    def two_deep_guarded(us, mesh, state, t):
        if bool(torch.any(t)):
            deeper(us, mesh, state)
"""

PORT_ONLY_GOOD = """
    import torch
    from heat3d_tpu_torch.parallel import distributed

    def world_sized(u):
        if distributed.process_count() > 1:
            distributed.barrier()

    def device_object(dev, u):
        device = torch.device(dev)
        if device.type == "cuda":
            distributed.barrier()

    def file_flush(f, rank):
        if distributed.process_index() == 0:
            f.flush()
"""


def test_collective_divergence_port_vocabulary(tmp_path):
    bad = _write(tmp_path, "portpkg/bad_extra.py", PORT_ONLY_BAD)
    by_sym = {f.symbol: f for f in collectives.check(str(tmp_path), files=[bad])}
    assert by_sym["slot_guarded"].code == "ANL102"
    assert by_sym["item_guarded"].code == "ANL103"
    assert by_sym["env_guarded"].code == "ANL101"
    # the fixpoint sees a fused launch two helpers deep
    assert by_sym["two_deep_guarded"].code == "ANL103"
    assert "deeper -> deep -> apply_superstep_fused_dma" in by_sym["two_deep_guarded"].message
    good = _write(tmp_path, "portpkg/good_extra.py", PORT_ONLY_GOOD)
    assert collectives.check(str(tmp_path), files=[good]) == []


def test_collective_divergence_live_port_is_clean():
    """Over the port and chip_smoke.py, with the inline suppression of
    ``tune/cache.py`` (rank 0's resolution) applied: no finding."""
    found = collectives.check(REPO)
    kept, suppressed = apply_suppressions(REPO, found, {})
    assert kept == []
    assert [f.path for f in suppressed] == ["heat3d_tpu_torch/tune/cache.py"]


_RANK_RESOLVE = r"""
import sys
rank, port, store = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
from heat3d_tpu_torch.parallel import distributed
distributed.initialize(f"localhost:{port}", 2, rank)
from heat3d_tpu_torch.core.config import GridConfig, MeshConfig, SolverConfig
from heat3d_tpu_torch.tune import cache
cfg = SolverConfig(grid=GridConfig(shape=(16, 16, 16)), mesh=MeshConfig(shape=(2, 1, 1)),
                   time_blocking=0, halo="auto", overlap=True)
if rank == 0:
    win = SolverConfig(grid=GridConfig(shape=(16, 16, 16)), mesh=MeshConfig(shape=(2, 1, 1)),
                       time_blocking=2, backend="pallas", halo="dma", overlap=True)
    cache.store_entry(cache.cache_key(cfg, device="cpu"), win, 1.0, path=store, device="cpu")
distributed.barrier()
out = cache.resolve_config(cfg, path=store, device="cpu")
print("RESOLVED", out.time_blocking, out.halo, flush=True)
distributed.shutdown()
"""


def test_rank_zero_resolution_reaches_no_collective(tmp_path):
    """The one suppressed site (``tune/cache.py``, rank 0 resolves alone
    and broadcasts): with a store hit, rank 0's build check constructs a
    two-process solver while rank 1 waits in the broadcast — both ranks
    finish with the same resolved knobs, no hang (the lint's chain is cut
    at run time: plans build on first use)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "rank.py"
    script.write_text(_RANK_RESOLVE)
    env = dict(os.environ, HEAT3D_DIST_TIMEOUT_S="60", HEAT3D_TUNE_CACHE=str(tmp_path / "x"))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port),
                               str(tmp_path / "store.json"), REPO],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in (0, 1)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "RESOLVED 2 dma" in out, out


# ---- fail-soft -------------------------------------------------------------

LEAKY_OBS = """
    import json

    def leaky_write(path, payload):
        with open(path, "w") as f:
            f.write(payload)

    def leaky_encode(payload):
        return json.dumps(payload)

    def guarded_write(path, payload):
        try:
            with open(path, "w") as f:
                f.write(payload)
        except OSError:
            pass

    def calls_leaky(path):
        leaky_write(path, "x")

    def guards_leaky_call(path):
        try:
            leaky_write(path, "x")
        except Exception:
            pass
"""


def test_failsoft_fires_as_jax(tmp_path):
    relp = "obspkg/telemetry.py"
    _write(tmp_path, relp, LEAKY_OBS)
    contract = {relp: ("leaky_write", "leaky_encode", "guarded_write", "calls_leaky",
                       "guards_leaky_call", "renamed_away")}
    got = failsoft.check(str(tmp_path), contract=contract)
    want = ref_failsoft.check(str(tmp_path), contract=contract)
    assert _sites(got) == _sites(want)
    by_sym = {f.symbol: f for f in got}
    assert by_sym["leaky_write"].code == "ANL201"
    assert "TypeError" in by_sym["leaky_encode"].message
    assert by_sym["calls_leaky"].code == "ANL201"
    assert by_sym["renamed_away"].code == "ANL202"
    assert "guarded_write" not in by_sym and "guards_leaky_call" not in by_sym


def test_failsoft_live_port_obs_is_clean():
    assert failsoft.check(REPO) == []


# ---- ledger-taxonomy -------------------------------------------------------

BAD_TAXONOMY = """
    import os

    def run(ledger):
        ledger.event("unregistered_event")
        with ledger.span("run_loop"):
            pass
        ledger.event("warmup")  # registered as a span
        os.environ.get("HEAT3D_MYSTERY_KNOB")
"""

_EVENTS = {
    "run_start": {"kind": "point", "desc": "x"},
    "run_loop": {"kind": "span", "desc": "x"},
    "warmup": {"kind": "span", "desc": "x"},
    "stale_event": {"kind": "point", "desc": "x"},
}
_DOCS = ("| `run_start` | point | x |\n| `run_loop` | span | x |\n"
         "| `warmup` | span | x |\n| `HEAT3D_DOCUMENTED_KNOB` | x |\n")


def test_taxonomy_fires_as_jax(tmp_path):
    path = _write(tmp_path, "pkg/emitters.py", BAD_TAXONOMY)
    _write(tmp_path, "docs/OBS.md", _DOCS)
    kw = dict(files=[path], events_registry=_EVENTS,
              env_registry={"HEAT3D_DOCUMENTED_KNOB": {"desc": "x"}},
              docs_path="docs/OBS.md")
    got = taxonomy.check(str(tmp_path), **kw)
    want = ref_taxonomy.check(str(tmp_path), **kw)
    assert _sites(got) == _sites(want)
    assert {f.code for f in got} == {"ANL401", "ANL402", "ANL403", "ANL404", "ANL411",
                                     "ANL413"}
    # a missing docs file is a finding in both
    kw["docs_path"] = "docs/NONE.md"
    assert "ANL405" in {f.code for f in taxonomy.check(str(tmp_path), **kw)}


def test_taxonomy_reference_events_exempt_from_emission(tmp_path):
    """An event only the JAX package emits (the IR tier's) is registered and
    documented in the port, and never flagged as stale there."""
    from heat3d_tpu_torch.analysis.registry import LEDGER_EVENTS, REFERENCE_EVENTS

    assert "ir_lint_verdict" in REFERENCE_EVENTS
    assert REFERENCE_EVENTS <= set(LEDGER_EVENTS)
    found = taxonomy.check(REPO)
    assert not [f for f in found if f.symbol in REFERENCE_EVENTS]


def test_taxonomy_registry_covers_every_name_the_port_reads():
    """Every HEAT3D_* token of the port and chip_smoke.py is registered
    with its kind, and the live taxonomy leg is clean."""
    from heat3d_tpu_torch.analysis.registry import ENV_VARS

    assert {v["kind"] for v in ENV_VARS.values()} == {"env", "define"}
    for name in ("HEAT3D_WIRE", "HEAT3D_COORDINATOR", "HEAT3D_DIST_TIMEOUT_S",
                 "HEAT3D_AOT_CACHE", "HEAT3D_BURN_FAST_S", "HEAT3D_SERVE_WORKERS",
                 "HEAT3D_MEHRSTELLEN", "HEAT3D_FUSED_RDMA", "HEAT3D_CHAIN_27PT"):
        assert name in ENV_VARS
    assert taxonomy.check(REPO) == []


# ---- knob-drift ------------------------------------------------------------

_KNOBS = ("backend", "halo")
_SPACE = ("backend", "halo", "mesh")
_FLAGS = ("--backend", "--halo")
_ROWS = {"backend", "halo", "platform"}
_ROUTES = ("platform",)
_DOC = "backend halo"

_DRIFTS = [
    dict(knobs=_KNOBS + ("bogus_knob",)),
    dict(space_keys=_SPACE + ("mystery",)),
    dict(space_keys=("backend", "mesh")),
    dict(cli_flags=("--backend",)),
    dict(row_strings={"backend", "platform"}),
    dict(route_fields=("platform", "new_route")),
    dict(tuning_doc="backend only"),
    dict(),
]


@pytest.mark.parametrize("drift", _DRIFTS, ids=lambda d: ",".join(d) or "agree")
def test_knob_drift_fires_as_jax(drift):
    args = dict(knobs=_KNOBS, space_keys=_SPACE, cli_flags=_FLAGS, row_strings=_ROWS,
                route_fields=_ROUTES, tuning_doc=_DOC)
    args.update(drift)
    got = knobs.check(REPO, **args)
    want = ref_knobs.check(REPO, **args)
    assert _sites(got) == _sites(want)
    assert bool(got) == bool(drift)


def test_knob_drift_live_port_surfaces_agree():
    assert knobs.check(REPO) == []
    assert knobs._harness_row_keys(REPO, knobs._HARNESS_PY) >= set(provenance.ROUTE_FIELDS)


# ---- eqn-registry ----------------------------------------------------------


class _Fam:
    def mms_rates(self, *a):
        return (0.0, 0.0)


_FAMS = {"heat": _Fam(), "wave": _Fam()}
_EQ_DOC = "| `heat` | x |\n| `wave` | x |\n"
_EQ_TESTS = "'heat' 'wave'"

_EQ_DRIFTS = [
    dict(cli_choices=["heat"]),
    dict(cli_choices=["heat", "wave", "ghost"]),
    dict(doc_text="| `heat` | x |\n"),
    dict(doc_text=_EQ_DOC + "| `stale` | x |\n"),
    dict(families={"heat": _Fam(), "wave": object()}),
    dict(tests_text="'heat'"),
    dict(),
]


@pytest.mark.parametrize("drift", _EQ_DRIFTS, ids=lambda d: ",".join(d) or "agree")
def test_eqn_registry_fires_as_jax(drift):
    args = dict(families=_FAMS, cli_choices=["heat", "wave"], doc_text=_EQ_DOC,
                tests_text=_EQ_TESTS)
    args.update(drift)
    got = eqnlint.check(REPO, **args)
    want = ref_eqnlint.check(REPO, **args)
    assert [(f.code, f.symbol) for f in got] == [(f.code, f.symbol) for f in want]
    assert bool(got) == bool(drift)


def test_eqn_registry_live_port_is_clean():
    assert eqnlint.check(REPO) == []


# ---- provenance ------------------------------------------------------------

_ROWS_JSONL = [
    {"bench": "halo", "p50_ms": 1.0},
    {"bench": "halo", "ts": "t", "platform": "cuda", "sync_rtt_s": 0.1,
     "halo_plan": "monolithic"},
    {"bench": "throughput", "ts": "t", "time_blocking": 2},
    {"bench": "soak", "submitted": 3, "admitted": 2, "shed": 0, "delivered": 2},
    {"bench": "weak_scaling", "post_heal": True},
    {"note": "foreign lines pass"},
]


def test_provenance_findings_equal_jax(tmp_path):
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in _ROWS_JSONL) + "\n{bad json\n")
    got = [f.to_dict() for f in provenance.check_file_findings(str(path))]
    want = [f.to_dict() for f in ref_provenance.check_file_findings(str(path))]
    assert got == want and got
    assert provenance.ROUTE_FIELDS == ref_provenance.ROUTE_FIELDS
    for r in _ROWS_JSONL:
        assert provenance.check_row(r) == ref_provenance.check_row(r)


def _port_rows():
    """A throughput and a halo row of the port's harness (built from
    timings, as the harness builds them after a run on the card)."""
    import torch

    from heat3d_tpu_torch.bench.harness import halo_row, throughput_row
    from heat3d_tpu_torch.core.config import GridConfig, MeshConfig, SolverConfig

    cfg = SolverConfig(grid=GridConfig.cube(16), mesh=MeshConfig(shape=(2, 2, 2)),
                       time_blocking=2)
    dev = [torch.device("cpu")]
    return [throughput_row(cfg, steps=8, steps_requested=5, times=[0.02, 0.01, 0.03],
                           devices=dev, shards=8, sync_rtt_s=1e-5,
                           kernel_launches={"apply_taps_direct2": 4}),
            halo_row(cfg, k=25, iters=3, times=[1e-4, 2e-4, 3e-4], devices=dev, shards=8,
                     sync_rtt_s=1e-5)]


def test_provenance_port_rows_are_clean(tmp_path):
    """Rows of the port's own harness pass the port's lint (before, only
    the JAX check_row held them)."""
    rows = _port_rows()
    for r in rows:
        assert provenance.check_row(r) == []
        assert ref_provenance.check_row(r) == []
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert provenance.main(["--start-line", "1", str(path)]) == 0


# ---- the port is lint-clean ------------------------------------------------


def test_port_is_lint_clean():
    """Acceptance: ``python -m heat3d_tpu_torch lint --json`` in a child
    that cannot import JAX exits 0 with no error and lists the catalog."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['heat3d_tpu'] = None; "
            "from heat3d_tpu_torch.cli import main; sys.exit(main(['lint', '--json']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["counts"]["error"] == 0
    assert payload["checkers"] == list(CHECKERS)
    assert set(CHECKERS) == {"collective-divergence", "fail-soft", "ledger-taxonomy",
                             "knob-drift", "eqn-registry"}
    assert [f for f in payload["findings"] if f["severity"] == "error"] == []
    assert payload["suppressed"] == 1
