"""The port's autotuner on the CPU (``heat3d_tpu_torch.tune``), held to the
JAX package's ``heat3d_tpu.tune``: the counterparts of ``tests/test_tune.py``
(the decision logic, the lattice and its pruning, the store, resolution
hit/miss/stale/disabled, the search loop's rules, ``tune run|show|apply``
and the e2e loop: a CPU ``tune run`` writes an entry that a
``time_blocking=0`` solver resolves, bitwise equal to the explicit config);
parity with the JAX functions (``decide``, byte-equal ``cache_key`` over a
parametrised config set with the ``s`` leg where shards share a device,
``enumerate_candidates`` apart from the documented ``dma`` difference);
staleness across one store shared by both packages; and the step and
plan factories'
refusal of an unresolved auto sentinel."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

from heat3d_tpu import obs as jobs
from heat3d_tpu.core import config as jconfig
from heat3d_tpu.tune import cache as jcache
from heat3d_tpu.tune import decide as jdecide
from heat3d_tpu.tune import space as jspace
from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import (
    GridConfig,
    MeshConfig,
    Precision,
    SolverConfig,
    StencilConfig,
)
from heat3d_tpu_torch.models.heat3d import HeatSolver3D
from heat3d_tpu_torch.tune import cache as tcache
from heat3d_tpu_torch.tune import decide as tdecide
from heat3d_tpu_torch.tune import space as tspace


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Every test gets its own store (both packages read the same env var)
    and detached ledgers."""
    monkeypatch.setenv(tcache.ENV_CACHE, str(tmp_path / "tune_cache.json"))
    monkeypatch.delenv(tcache.ENV_DISABLE, raising=False)
    monkeypatch.delenv("HEAT3D_LEDGER", raising=False)
    obs.deactivate()
    jobs.deactivate()
    yield
    obs.deactivate()
    jobs.deactivate()


def _cfg(n=12, **kw):
    return SolverConfig(grid=GridConfig.cube(n), **kw)


def _row(gcell):
    return {"gcell_per_sec_per_chip": gcell}


def _read(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def _cpu_solver(cfg):
    return HeatSolver3D(cfg, device="cpu")


# ---- tune.decide -----------------------------------------------------------


def test_decide_pairs_single_knob_only():
    entries = [
        ({"tb": "1", "ov": "0"}, _row(10.0)),
        ({"tb": "2", "ov": "0"}, _row(12.0)),  # pairs with #1 on tb
        ({"tb": "2", "ov": "1"}, _row(15.0)),  # pairs with #2 on ov
        ({"halo": "dma"}, _row(9.0)),  # different knob set: never pairs
    ]
    ds = tdecide.decide(entries)
    assert {(d["knob"], tuple(sorted(d["context"].items()))) for d in ds} == {
        ("tb", (("ov", "0"),)),
        ("ov", (("tb", "2"),)),
    }
    tb = next(d for d in ds if d["knob"] == "tb")
    assert tb["winner"] == "2"
    assert tb["speedup_pct"] == pytest.approx(20.0)


def test_decide_min_win_threshold():
    entries = [({"tb": "1"}, _row(100.0)), ({"tb": "2"}, _row(103.0))]
    (d,) = tdecide.decide(entries, min_win_pct=5.0)
    assert not d["decisive"] and "keep default" in d["recommend"]
    (d,) = tdecide.decide(entries, min_win_pct=2.0)
    assert d["decisive"]


def test_decide_margin_orientation_symmetric():
    a = tdecide.decide([({"k": "0"}, _row(10.0)), ({"k": "1"}, _row(12.0))])
    b = tdecide.decide([({"k": "1"}, _row(10.0)), ({"k": "0"}, _row(12.0))])
    assert a[0]["speedup_pct"] == b[0]["speedup_pct"] == pytest.approx(20.0)


def test_parse_lines_scopes_to_last_session():
    text = "\n".join([
        "=== tpu_measure_all old",
        'tb=1: {"gcell_per_sec_per_chip": 1.0}',
        "=== tpu_measure_all new",
        'tb=2: {"gcell_per_sec_per_chip": 2.0}',
    ])
    got = list(tdecide.parse_lines(text))
    assert [k for k, _ in got] == [{"tb": "2"}]
    assert len(list(tdecide.parse_lines(text, all_sessions=True))) == 2


_DECIDE_CASES = [
    [({"tb": "1", "ov": "0"}, _row(10.0)), ({"tb": "2", "ov": "0"}, _row(12.0)),
     ({"tb": "2", "ov": "1"}, _row(15.0)), ({"halo": "dma"}, _row(9.0))],
    [({"tb": "1"}, _row(100.0)), ({"tb": "2"}, _row(103.0)), ({"tb": "3"}, _row(99.0))],
    [({"mode": "direct"}, {"gcell_updates_per_sec_per_chip": 7.0}),
     ({"mode": "stream"}, {"gcell_updates_per_sec_per_chip": 5.0}),
     ({"mode": "x"}, {"other": 1.0})],
    [({"k": "b"}, _row(0.0)), ({"k": "a"}, _row(2.0)), ({"k": "c"}, _row(2.0))],
]


@pytest.mark.parametrize("entries", _DECIDE_CASES, ids=range(len(_DECIDE_CASES)))
@pytest.mark.parametrize("min_win", [5.0, 1.0])
def test_decide_equals_jax(entries, min_win):
    """The same row lists give the same decisions and the same report
    lines through both packages' ``decide``."""
    mine = tdecide.decide(entries, min_win_pct=min_win)
    ref = jdecide.decide(entries, min_win_pct=min_win)
    assert mine == ref
    assert [tdecide.format_decision(d) for d in mine] == [
        jdecide.format_decision(d) for d in ref]
    lower = tdecide.decide(entries, metric=lambda r: r.get("gcell_per_sec_per_chip"),
                           prefer="lower")
    assert lower == jdecide.decide(entries, metric=lambda r: r.get("gcell_per_sec_per_chip"),
                                   prefer="lower")


def test_decide_cli_reads_a_log(tmp_path, capsys):
    log = tmp_path / "m.log"
    log.write_text('tb=1: {"gcell_per_sec_per_chip": 10.0}\n'
                   'tb=2: {"gcell_per_sec_per_chip": 20.0}\n')
    assert tdecide.main([str(log)]) == 0
    out = capsys.readouterr().out
    assert "time_blocking" not in out and "tb" in out and "FLIP?" in out
    assert tdecide.main([str(tmp_path / "none.log")]) == 2


# ---- tune.space ------------------------------------------------------------


def _by_label(cands):
    return {tuple(sorted(c.knobs.items())): c for c in cands}


def test_space_prunes_invalid_and_keeps_dma_measurable():
    """The JAX test's lattice: invalid combos pruned by config validation,
    the static default first; the documented difference: the port's
    ``halo='dma'`` builds on the CPU (the kernels' plain versions), so a
    dma candidate is measurable where the JAX package prunes it off the
    TPU."""
    base = _cfg(backend="jnp")
    space = {"halo": ("ppermute", "dma"), "halo_order": ("axis", "pairwise"),
             "time_blocking": (1, 2)}
    cands = tspace.enumerate_candidates(base, space, make_solver=_cpu_solver)
    by = _by_label(cands)

    def get(halo, order, tb):
        return by[tuple(sorted({"halo": halo, "halo_order": order,
                                "time_blocking": str(tb)}.items()))]

    assert cands[0].prune is None and cands[0].knobs["halo"] == "ppermute"
    assert get("dma", "axis", 1).prune is None
    assert get("dma", "axis", 2).prune is None
    assert get("ppermute", "pairwise", 2).prune.startswith("invalid:")
    assert get("dma", "pairwise", 1).prune.startswith("invalid:")
    assert get("ppermute", "pairwise", 1).prune is None
    # the JAX package prunes the same dma candidates for the platform
    jcands = jspace.enumerate_candidates(jconfig.SolverConfig(
        grid=jconfig.GridConfig.cube(12), backend="jnp"), space)
    jby = _by_label(jcands)
    jdma = jby[tuple(sorted({"halo": "dma", "halo_order": "axis",
                             "time_blocking": "1"}.items()))]
    assert "dma" in (jdma.prune or "")


def test_space_searches_deep_tb_and_prunes_invalid():
    assert tspace.DEFAULT_KNOBS["time_blocking"] == (1, 2, 3, 4)
    cands = tspace.enumerate_candidates(_cfg(2, backend="jnp"), {"time_blocking": (1, 2, 3, 4)},
                                        make_solver=_cpu_solver)
    by_tb = {c.knobs["time_blocking"]: c for c in cands}
    assert by_tb["1"].prune is None
    for tb in ("2", "3", "4"):
        assert "needs local extents" in (by_tb[tb].prune or ""), by_tb[tb]
    cands8 = tspace.enumerate_candidates(_cfg(backend="jnp"), {"time_blocking": (3, 4)},
                                         make_solver=_cpu_solver)
    assert all(c.prune is None for c in cands8)
    pw = tspace.enumerate_candidates(_cfg(backend="jnp"),
                                     {"halo_order": ("pairwise",), "time_blocking": (3,)},
                                     make_solver=_cpu_solver)
    deep = [c for c in pw if c.knobs.get("halo_order") == "pairwise"
            and c.knobs.get("time_blocking") == "3"]
    assert deep and all((c.prune or "").startswith("invalid:") for c in deep)


def test_parse_knob_values_deep_tb():
    assert tspace.parse_knob_values("time_blocking", "1,2,3,4") == (1, 2, 3, 4)
    assert tspace.parse_knob_values("mesh", "8x1x1,2x2x2") == ((8, 1, 1), (2, 2, 2))
    assert tspace.parse_knob_values("overlap", "0,true") == (False, True)


def test_space_prunes_pairwise_for_27pt():
    base = _cfg(backend="jnp", stencil=StencilConfig(kind="27pt"))
    cands = tspace.enumerate_candidates(base, {"halo_order": ("axis", "pairwise")},
                                        make_solver=_cpu_solver)
    pw = [c for c in cands if c.knobs["halo_order"] == "pairwise"]
    assert pw and all("invalid" in c.prune for c in pw)


def test_space_prunes_oversized_mesh(monkeypatch):
    """A mesh of more shards than visible GPUs (the default placement,
    shard i on cuda:i) is pruned with the placement's own error."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cands = tspace.enumerate_candidates(_cfg(backend="jnp"), {"mesh": ((64, 1, 1),)})
    over = [c for c in cands if c.knobs["mesh"] == "64x1x1"]
    assert over and all("needs 64 devices" in c.prune for c in over)


def test_space_rejects_non_concrete_knob_values():
    with pytest.raises(ValueError, match="concrete"):
        tspace.parse_knob_values("time_blocking", "0,2")
    with pytest.raises(ValueError, match="concrete"):
        tspace.parse_knob_values("halo", "auto,dma")
    with pytest.raises(ValueError, match="not concrete"):
        tspace.enumerate_candidates(_cfg(backend="jnp"), {"time_blocking": (0, 2)},
                                    validate=False)


def test_mesh_candidates_shapes():
    ms = tspace.mesh_candidates(8)
    assert (8, 1, 1) in ms and (2, 2, 2) in ms
    assert all(a * b * c == 8 for a, b, c in ms)
    assert ms == jspace.mesh_candidates(8)


def test_default_knobs_and_labels_equal_jax():
    assert tspace.DEFAULT_KNOBS == jspace.DEFAULT_KNOBS
    base = _cfg(backend="jnp")
    jbase = jconfig.SolverConfig(grid=jconfig.GridConfig.cube(12), backend="jnp")
    for over in ({}, {"time_blocking": 2, "overlap": True}, {"mesh": (2, 1, 1)}):
        space = dict(tspace.DEFAULT_KNOBS, mesh=((1, 1, 1), (2, 1, 1)))
        assert tspace.knob_label(base, space, over) == jspace.knob_label(jbase, space, over)


_PARITY_SPACE = {
    "halo": ("ppermute", "dma"), "overlap": (False, True), "time_blocking": (1, 2, 3),
    "halo_order": ("axis", "pairwise"), "halo_plan": ("monolithic", "partitioned"),
    "fused_rdma": ("off", "on"),
}


def test_enumerate_candidates_equals_jax_apart_from_dma():
    """Over one base and one space, both packages list the same labels in
    the same order and prune the same set, apart from the named difference:
    a ``dma`` candidate the JAX package prunes off the TPU is measurable on
    the port's CPU plain versions."""
    base = _cfg(backend="jnp")
    jbase = jconfig.SolverConfig(grid=jconfig.GridConfig.cube(12), backend="jnp")
    mine = tspace.enumerate_candidates(base, _PARITY_SPACE, make_solver=_cpu_solver)
    ref = jspace.enumerate_candidates(jbase, _PARITY_SPACE)
    assert [c.knobs for c in mine] == [c.knobs for c in ref]
    differ = [(c.knobs, c.prune, r.prune) for c, r in zip(mine, ref)
              if (c.prune is None) != (r.prune is None)]
    assert differ, "the dma difference should show on this space"
    for knobs, port_prune, jax_prune in differ:
        assert knobs["halo"] == "dma" and port_prune is None and "dma" in jax_prune
    # structural rejections are word for word the same
    for c, r in zip(mine, ref):
        if (r.prune or "").startswith("invalid:"):
            assert c.prune == r.prune


# ---- the pairwise ordering -------------------------------------------------


def test_pairwise_exchange_matches_axis_on_stencil_cells():
    """On one shard the pairwise padded block equals the axis-ordered one
    on every cell a 7pt stencil reads, and a solve agrees to fp32
    tolerance."""
    import torch

    from heat3d_tpu_torch.core.config import BoundaryCondition
    from heat3d_tpu_torch.parallel.plan import ExchangePlan
    from heat3d_tpu_torch.parallel.topology import build_shard_mesh

    base = _cfg(backend="jnp")
    mesh = build_shard_mesh(base, "cpu")
    u0 = np.random.default_rng(0).standard_normal((12, 12, 12)).astype(np.float32)
    u = torch.from_numpy(u0)
    pa = ExchangePlan(mesh, BoundaryCondition.DIRICHLET, 1, "ppermute", torch.float32
                      ).apply([u], 0.0)[0].clone()
    pb = ExchangePlan(mesh, BoundaryCondition.DIRICHLET, 1, "ppermute", torch.float32,
                      halo_order="pairwise").apply([u], 0.0)[0]
    faces = torch.zeros_like(pa, dtype=torch.bool)
    faces[1:-1, 1:-1, :] = faces[1:-1, :, 1:-1] = faces[:, 1:-1, 1:-1] = True
    assert torch.equal(pa[faces], pb[faces])
    sa = HeatSolver3D(base, device="cpu")
    sb = HeatSolver3D(dataclasses.replace(base, halo_order="pairwise"), device="cpu")
    ua = sa.gather(sa.run(sa.init_state(u0), 5))
    ub = sb.gather(sb.run(sb.init_state(u0), 5))
    np.testing.assert_allclose(ua, ub, rtol=1e-6, atol=1e-6)


def test_pairwise_pins_exchange_path():
    from heat3d_tpu_torch.parallel.step import step_route

    cfg = dataclasses.replace(_cfg(backend="auto"), halo_order="pairwise")
    assert step_route(cfg) == "exchange"
    assert step_route(_cfg(backend="auto")) == "direct"


# ---- tune.cache: keys ------------------------------------------------------

_KEY_WORKLOADS = [("heat", "explicit-euler", ()),
                  ("advection-diffusion", "explicit-euler", (("vx", 0.25),)),
                  ("wave", "leapfrog", ())]


def _key_pair(kind, storage, workload, devices):
    equation, integrator, params = workload
    mesh = (2, 2, 2) if devices == 8 else (1, 1, 1)
    kw = dict(stencil_kind=kind, storage=storage, equation=equation, integrator=integrator,
              eq_params=params, mesh=mesh)

    def build(mod):
        return mod.SolverConfig(
            grid=mod.GridConfig(shape=(32, 32, 32), dt=0.01),
            stencil=mod.StencilConfig(kind=kw["stencil_kind"]),
            mesh=mod.MeshConfig(shape=kw["mesh"]),
            precision=mod.Precision(storage=kw["storage"]),
            backend="jnp" if integrator != "explicit-euler" else "auto",
            equation=equation, eq_params=params, integrator=integrator)

    from heat3d_tpu_torch.core import config as pconfig

    return build(pconfig), build(jconfig)


# every (stencil, storage, workload, devices) the families allow
# (advection-diffusion has no 27pt form)
_KEY_CASES = [
    (kind, storage, workload, devices)
    for kind in ("7pt", "27pt") for storage in ("float32", "bfloat16")
    for workload in _KEY_WORKLOADS for devices in (1, 8)
    if not (kind == "27pt" and workload[0] == "advection-diffusion")
]


@pytest.mark.parametrize("kind,storage,workload,devices", _KEY_CASES,
                         ids=[f"{k}-{s}-{w[0]}-{w[1]}-d{d}" for k, s, w, d in _KEY_CASES])
def test_cache_key_equals_jax(monkeypatch, kind, storage, workload, devices):
    """With the chip patched to one name in both packages, one shard per
    device keys byte-equal to the JAX key; every shard on one device adds
    the ``s`` leg to it (and one shard alone adds none)."""
    mine, ref = _key_pair(kind, storage, workload, devices)
    monkeypatch.setattr(tcache, "chip_generation", lambda device=None: "chip-x")
    monkeypatch.setattr(jcache, "chip_generation", lambda: "chip-x")
    jkey = jcache.cache_key(ref)
    assert tcache.cache_key(mine) == jkey
    want = jkey + ("|s8" if devices == 8 else "")
    assert tcache.cache_key(mine, device="cuda:0") == want
    assert tcache.cache_key(mine, batch_size=4) == jcache.cache_key(ref, batch_size=4)


def test_chip_generation_names_the_device():
    assert tcache.chip_generation() == "cpu"
    assert tcache.chip_generation("cpu") == "cpu"
    assert tcache.cache_key(_cfg(), device="cpu").startswith("cpu|p1|d1|")
    assert tcache.process_count() == 1


# ---- tune.cache: store, lint, resolution -----------------------------------


def _seed_entry(cfg=None, key=None, device=None, **config_over):
    """One entry for ``cfg``'s key as a prior ``tune run`` writes it."""
    cfg = cfg or _cfg()
    winner = dataclasses.replace(cfg, backend="jnp", halo="ppermute", time_blocking=2,
                                 **config_over)
    key = key or tcache.cache_key(cfg, device=device)
    path = tcache.store_entry(key, winner, 2.0, default_metric=1.0)
    return key, path


def _forge(path, key, **prov):
    doc = json.load(open(path))
    doc["entries"][key]["provenance"].update(prov)
    for k, v in prov.items():
        if v is None:
            del doc["entries"][key]["provenance"][k]
    with open(path, "w") as f:
        json.dump(doc, f)


def test_cache_store_show_lint_roundtrip():
    key, path = _seed_entry()
    assert tcache.lint() == []
    e = tcache.load()["entries"][key]
    assert e["config"]["time_blocking"] == 2 and e["gcell_per_sec_per_chip"] == 2.0
    prov = e["provenance"]
    assert prov["torch_version"] and prov["kernels"] == tcache.kernels_digest()
    assert "jax_version" not in prov and prov["platform"] == "cpu"
    doc = json.load(open(path))
    doc["entries"][key]["config"].pop("halo")
    del doc["entries"][key]["gcell_per_sec_per_chip"]
    del doc["entries"][key]["provenance"]["kernels"]
    with open(path, "w") as f:
        json.dump(doc, f)
    defects = tcache.lint()
    assert any("halo" in d for d in defects)
    assert any("gcell_per_sec_per_chip" in d for d in defects)
    assert any("kernels digest" in d for d in defects)


def test_resolve_hit_applies_only_auto_knobs(tmp_path):
    _seed_entry()
    ledger = str(tmp_path / "led.jsonl")
    obs.activate(ledger)
    r = tcache.resolve_config(_cfg(backend="auto", halo="auto", time_blocking=0),
                              device="cpu")
    assert (r.backend, r.halo, r.time_blocking) == ("jnp", "ppermute", 2)
    r2 = tcache.resolve_config(_cfg(backend="auto", halo="auto", time_blocking=1),
                               device="cpu")
    assert r2.time_blocking == 1 and r2.backend == "jnp"
    r3 = tcache.resolve_config(_cfg(backend="pallas", time_blocking=0), device="cpu")
    assert (r3.backend, r3.time_blocking) == ("pallas", 2)
    obs.deactivate()
    hits = [e for e in _read(ledger) if e["event"] == "tune_cache_hit"]
    assert len(hits) == 3
    assert hits[0]["applied"] == {"backend": "jnp", "halo": "ppermute", "time_blocking": 2}
    assert hits[2]["applied"] == {"time_blocking": 2}


def test_resolve_miss_and_absent_cache_fall_back_static(tmp_path):
    ledger = str(tmp_path / "led.jsonl")
    obs.activate(ledger)
    r = tcache.resolve_config(_cfg(halo="auto", time_blocking=0, halo_plan="auto",
                                   fused_rdma="auto"))
    assert (r.halo, r.time_blocking, r.halo_plan, r.fused_rdma) == (
        "ppermute", 1, "monolithic", "off")
    assert r.backend == "auto"  # the solver's own rule: the kernels
    obs.deactivate()
    (miss,) = [e for e in _read(ledger) if e["event"] == "tune_cache_miss"]
    assert miss["cache_present"] is False
    assert miss["autos"] == ["backend", "halo", "time_blocking", "halo_plan", "fused_rdma"]


@pytest.mark.parametrize("field,value,needle", [
    ("torch_version", "0.0.0-not-this-one", "torch_version"),
    ("kernels", "0123456789abcdef", "kernels"),
])
def test_resolve_stale_on_stack_mismatch(tmp_path, field, value, needle):
    """Another torch, or other kernels (sources, headers, flags): the
    entry is stale with that reason and the static defaults run."""
    key, path = _seed_entry()
    _forge(path, key, **{field: value})
    ledger = str(tmp_path / "led.jsonl")
    obs.activate(ledger)
    r = tcache.resolve_config(_cfg(halo="auto", time_blocking=0), device="cpu")
    assert (r.halo, r.time_blocking) == ("ppermute", 1)
    obs.deactivate()
    (stale,) = [e for e in _read(ledger) if e["event"] == "tune_cache_stale"]
    assert needle in stale["reason"] and value in stale["reason"]


def test_resolve_dma_entry_hits_on_the_cpu(tmp_path):
    """The documented difference from the JAX package's dma gate: a cached
    ``halo='dma'`` is applied on the CPU, where the port's DMA transport
    runs its plain version; the JAX package marks it stale off the TPU."""
    cfg = _cfg(mesh=MeshConfig(shape=(2, 1, 1)))
    key = tcache.cache_key(cfg, device="cpu")
    assert key.endswith("|s2")
    path = tcache.store_entry(key, dataclasses.replace(cfg, backend="jnp", halo="dma"), 2.0)
    ledger = str(tmp_path / "led.jsonl")
    obs.activate(ledger)
    r = tcache.resolve_config(dataclasses.replace(cfg, halo="auto"), device="cpu")
    obs.deactivate()
    assert r.halo == "dma"
    assert [e["event"] for e in _read(ledger) if e["event"].startswith("tune_cache")] == [
        "tune_cache_hit"]
    assert path


def test_resolve_stale_on_cached_knobs_that_do_not_build(tmp_path):
    """A cached config that cannot BUILD here (a superstep deeper than the
    block) degrades to the static fallback with a stale event."""
    cfg = _cfg()
    key = tcache.cache_key(cfg, device="cpu")
    path = tcache.store_entry(key, dataclasses.replace(cfg, backend="jnp"), 2.0)
    doc = json.load(open(path))
    doc["entries"][key]["config"]["time_blocking"] = 16
    with open(path, "w") as f:
        json.dump(doc, f)
    ledger = str(tmp_path / "led.jsonl")
    obs.activate(ledger)
    r = tcache.resolve_config(_cfg(time_blocking=0), device="cpu")
    assert r.time_blocking == 1
    obs.deactivate()
    (stale,) = [e for e in _read(ledger) if e["event"] == "tune_cache_stale"]
    assert "do not build" in stale["reason"] and "local extents" in stale["reason"]


def test_resolve_miss_events_dedupe_per_run(tmp_path):
    ledger = str(tmp_path / "led.jsonl")
    obs.activate(ledger)
    tcache.resolve_config(_cfg(backend="auto"))
    tcache.resolve_config(_cfg(backend="auto"))
    obs.deactivate()
    assert len([e for e in _read(ledger) if e["event"] == "tune_cache_miss"]) == 1


def test_resolve_disabled_by_env(monkeypatch):
    _seed_entry()
    monkeypatch.setenv(tcache.ENV_DISABLE, "1")
    r = tcache.resolve_config(_cfg(backend="auto", time_blocking=0), device="cpu")
    assert r.backend == "auto" and r.time_blocking == 1


def test_non_euler_integrators_pin_without_the_cache(tmp_path):
    cfg = SolverConfig(grid=GridConfig(shape=(12, 12, 12), dt=0.01), equation="wave",
                       integrator="leapfrog", halo="auto", time_blocking=0)
    _seed_entry(cfg)
    ledger = str(tmp_path / "led.jsonl")
    obs.activate(ledger)
    r = tcache.resolve_config(cfg, device="cpu")
    obs.deactivate()
    assert (r.backend, r.halo, r.time_blocking) == ("jnp", "ppermute", 1)
    assert not [e for e in _read(ledger) if e["event"].startswith("tune_cache")]


def test_solver_resolves_auto_knobs_through_cache():
    """HeatSolver3D is the library-level safety net: an auto-knob config
    builds the cached route, keyed for the solver's own placement."""
    _seed_entry(device="cpu")
    s = HeatSolver3D(_cfg(backend="auto", halo="auto", time_blocking=0), device="cpu")
    assert s.cfg.time_blocking == 2 and s.cfg.backend == "jnp"


def test_cache_lint_catches_bad_peak():
    path = tcache.store_peak("somechip", 10.0)
    doc = json.load(open(path))
    doc["peaks"]["somechip"]["vector_gflops"] = -1
    with open(path, "w") as f:
        json.dump(doc, f)
    assert any("somechip" in d for d in tcache.lint())


# ---- one store shared by both packages -------------------------------------


def test_jax_entry_is_stale_for_the_port_but_no_lint_defect(tmp_path, capsys):
    """The JAX package's entry (``jax_version``, no ``torch_version``) under
    the same CPU key: stale for the port's resolution with a reason that
    names the JAX package, clean for the port's lint, shown as ``jax``."""
    from heat3d_tpu_torch.tune.cli import main as tune_main

    jcfg = jconfig.SolverConfig(grid=jconfig.GridConfig.cube(12))
    jkey = jcache.cache_key(jcfg)
    assert jkey == tcache.cache_key(_cfg())  # the CPU keys collide
    jcache.store_entry(jkey, dataclasses.replace(jcfg, backend="jnp", time_blocking=2), 5.0)
    assert tcache.lint() == []
    ledger = str(tmp_path / "led.jsonl")
    obs.activate(ledger)
    r = tcache.resolve_config(_cfg(time_blocking=0), device="cpu")
    obs.deactivate()
    assert r.time_blocking == 1
    (stale,) = [e for e in _read(ledger) if e["event"] == "tune_cache_stale"]
    assert "JAX package" in stale["reason"]
    capsys.readouterr()
    assert tune_main(["show"]) == 0
    assert "[jax]" in capsys.readouterr().out


def test_port_entry_is_stale_for_the_jax_package(tmp_path):
    """The port's entry has no ``jax_version``: the JAX package's own rule
    marks it stale and runs its static defaults (and its lint flags it,
    JAX behaviour the port does not change)."""
    _seed_entry()
    ledger = str(tmp_path / "jled.jsonl")
    jobs.activate(ledger)
    r = jcache.resolve_config(jconfig.SolverConfig(grid=jconfig.GridConfig.cube(12),
                                                   time_blocking=0))
    jobs.deactivate()
    assert r.time_blocking == 1
    (stale,) = [e for e in _read(ledger) if e["event"] == "tune_cache_stale"]
    assert "jax_version" in stale["reason"]
    assert any("jax_version" in d for d in jcache.lint())


# ---- the factories refuse an unresolved sentinel ---------------------------

_SENTINELS = [dict(halo="auto"), dict(halo_plan="auto"), dict(fused_rdma="auto"),
              dict(time_blocking=0)]


# the plans take only the transport and the plan mode
_FACTORY_CASES = [(b, a) for b in ("make_exchanges", "make_step_fn", "make_superstep_fn",
                                   "make_multistep_fn", "plan")
                  for a in _SENTINELS if b != "plan" or next(iter(a)) in ("halo", "halo_plan")]


@pytest.mark.parametrize("factory,auto", _FACTORY_CASES,
                         ids=[f"{b}-{next(iter(a))}" for b, a in _FACTORY_CASES])
def test_factories_raise_on_an_unresolved_sentinel(factory, auto):
    """A library call that skips resolution fails loudly, naming the knob,
    instead of quietly running a default."""
    from heat3d_tpu_torch.parallel import step
    from heat3d_tpu_torch.parallel.plan import Exchanges
    from heat3d_tpu_torch.parallel.topology import build_shard_mesh

    cfg = _cfg(mesh=MeshConfig(shape=(2, 1, 1)), **auto)
    mesh = build_shard_mesh(cfg, "cpu")
    knob = next(iter(auto))
    if factory == "plan":
        with pytest.raises(ValueError, match=f"{knob}='auto'"):
            Exchanges(mesh, cfg.stencil.bc, cfg.halo, cfg.halo_plan)
        return
    with pytest.raises(ValueError, match=knob):
        getattr(step, factory)(cfg, mesh)


# ---- the search loop -------------------------------------------------------


def _fake_bench(speeds=None, dominated=None):
    def bench(cfg, steps=50, warmup=2, repeats=3, device=None):
        tb = cfg.time_blocking
        return {"bench": "throughput",
                "gcell_per_sec_per_chip": (speeds or {}).get(tb, 1.0),
                "rtt_dominated": bool(dominated and dominated(cfg))}
    return bench


def test_search_early_stops_dominated_candidates(monkeypatch):
    from heat3d_tpu_torch.bench import harness
    from heat3d_tpu_torch.tune import measure as tmeasure

    monkeypatch.setattr(harness, "bench_throughput", _fake_bench({1: 10.0, 2: 1.0}))
    res = tmeasure.run_search(_cfg(12, backend="jnp"), space={"time_blocking": (1, 2)},
                              steps=4, repeats=1, probe_steps=2, write_cache=False,
                              device="cpu")
    statuses = {t.knobs["time_blocking"]: t.status for t in res.trials}
    assert statuses == {"1": "measured", "2": "dominated"}
    assert res.winner.knobs["time_blocking"] == "1"
    assert res.enumerate_s is not None and res.enumerate_s >= 0


def test_rtt_dominated_default_never_wins_or_anchors_speedup(monkeypatch):
    from heat3d_tpu_torch.bench import harness
    from heat3d_tpu_torch.tune import measure as tmeasure

    monkeypatch.setattr(harness, "bench_throughput",
                        _fake_bench({1: 9.0, 2: 3.0}, lambda cfg: cfg.time_blocking == 1))
    res = tmeasure.run_search(_cfg(12, backend="jnp"), space={"time_blocking": (1, 2)},
                              steps=4, repeats=1, probe_steps=0, device="cpu")
    assert res.winner.knobs["time_blocking"] == "2"
    assert res.speedup_vs_default is None
    entry = tcache.load()["entries"][res.key]
    assert entry["default_gcell_per_sec_per_chip"] is None
    assert entry["config"]["time_blocking"] == 2


def test_search_pins_base_auto_sentinels_to_static_defaults(monkeypatch):
    from heat3d_tpu_torch.bench import harness
    from heat3d_tpu_torch.tune import measure as tmeasure

    monkeypatch.setattr(harness, "bench_throughput", _fake_bench())
    res = tmeasure.run_search(_cfg(12, backend="auto", halo="auto", time_blocking=0),
                              space={"overlap": (False,)}, steps=2, repeats=1,
                              probe_steps=0, device="cpu")
    entry = tcache.load()["entries"][res.key]
    assert entry["config"]["halo"] == "ppermute"
    assert entry["config"]["time_blocking"] == 1
    assert entry["config"]["backend"] == "pallas"  # auto concretized: the kernels
    assert tcache.lint() == []


def test_tune_run_budget_zero_still_measures_default(tmp_path, monkeypatch):
    from heat3d_tpu_torch.bench import harness
    from heat3d_tpu_torch.tune import measure as tmeasure

    monkeypatch.setattr(harness, "bench_throughput", _fake_bench())
    ledger = str(tmp_path / "led.jsonl")
    obs.activate(ledger)
    res = tmeasure.run_search(_cfg(12, backend="jnp"), space={"time_blocking": (1, 2)},
                              budget_s=0.0, steps=4, repeats=1, probe_steps=0,
                              device="cpu")
    obs.deactivate()
    assert res.default is not None and res.default.status == "measured"
    assert any(t.status == "budget" for t in res.trials)
    assert [e for e in _read(ledger) if e["event"] == "tune_budget_exhausted"]


def test_crashing_trial_is_an_error_not_the_session(monkeypatch):
    from heat3d_tpu_torch.bench import harness
    from heat3d_tpu_torch.tune import measure as tmeasure

    def bench(cfg, steps=50, warmup=2, repeats=3, device=None):
        if cfg.time_blocking == 2:
            raise RuntimeError("boom")
        return {"gcell_per_sec_per_chip": 1.0}

    monkeypatch.setattr(harness, "bench_throughput", bench)
    res = tmeasure.run_search(_cfg(12, backend="jnp"), space={"time_blocking": (1, 2)},
                              steps=2, repeats=1, probe_steps=0, write_cache=False,
                              device="cpu")
    err = [t for t in res.trials if t.status == "error"]
    assert len(err) == 1 and "boom" in err[0].reason and res.winner is not None


def test_search_disables_the_cache_for_its_trials(monkeypatch):
    """An existing entry must not steer the trials that would replace it:
    ``HEAT3D_TUNE_DISABLE`` is set while they run and restored after."""
    from heat3d_tpu_torch.bench import harness
    from heat3d_tpu_torch.tune import measure as tmeasure

    seen = []

    def bench(cfg, steps=50, warmup=2, repeats=3, device=None):
        import os

        seen.append(os.environ.get(tcache.ENV_DISABLE))
        return {"gcell_per_sec_per_chip": 1.0}

    monkeypatch.setattr(harness, "bench_throughput", bench)
    tmeasure.run_search(_cfg(12, backend="jnp"), space={"time_blocking": (1,)}, steps=2,
                        repeats=1, probe_steps=0, write_cache=False, device="cpu")
    import os

    assert seen == ["1"] and tcache.ENV_DISABLE not in os.environ


_ENSEMBLE_SPACE = {
    "backend": ("jnp", "pallas", "conv"), "halo": ("ppermute", "dma"),
    "halo_order": ("axis", "pairwise"), "overlap": (False, True), "time_blocking": (1, 2),
}


def test_ensemble_search_prunes_single_tenant_routes_as_jax(monkeypatch):
    """``batch_members`` > 1: both searches prune the same candidates with
    the same ``ensemble:`` reasons, apart from the platform difference: off
    the TPU the JAX package prunes its ``pallas`` and ``dma`` candidates
    as TPU-only before the ensemble rule sees them, and the port (which
    builds them on the CPU) prunes them by the ensemble rule. The rule
    itself is the JAX one on every candidate."""
    from heat3d_tpu.tune import measure as jmeasure
    from heat3d_tpu_torch.tune import measure as tmeasure

    seen = []

    def fake(batch_members, device=None):
        def bench(cfg, steps, warmup, repeats):
            seen.append(batch_members)
            return _row(1.0)
        return bench

    monkeypatch.setattr(tmeasure, "_ensemble_bench", fake)
    monkeypatch.setattr(jmeasure, "_ensemble_bench", lambda b: fake(b))
    mine = tmeasure.run_search(_cfg(12, backend="jnp"), space=_ENSEMBLE_SPACE, steps=2,
                               repeats=1, probe_steps=0, write_cache=False,
                               batch_members=4, device="cpu")
    ref = jmeasure.run_search(
        jconfig.SolverConfig(grid=jconfig.GridConfig.cube(12), backend="jnp"),
        space=_ENSEMBLE_SPACE, steps=2, repeats=1, probe_steps=0, write_cache=False,
        batch_members=4)
    assert [t.knobs for t in mine.trials] == [t.knobs for t in ref.trials]
    pruned = 0
    for a, b in zip(mine.trials, ref.trials):
        assert tmeasure._ensemble_incompatible(a.overrides) == \
            jmeasure._ensemble_incompatible(b.overrides)
        if (b.reason or "").startswith("ensemble:"):
            assert (a.status, a.reason) == (b.status, b.reason)
            pruned += 1
        elif (a.reason or "").startswith("ensemble:"):
            assert "TPU" in b.reason and (
                a.knobs["halo"] == "dma" or a.knobs["backend"] == "pallas")
    assert pruned and set(seen) == {4}
    assert mine.key.endswith("|b2^2") and ref.key.endswith("|b2^2")


def test_ensemble_search_caches_the_batch_bucket_winner(capsys):
    """``tune run --batch-members 4`` on the CPU measures B-member batches,
    stores a ``jnp`` winner at the ``b2^2`` key, ``tune apply`` finds it,
    and an ensemble of 4 members with ``time_blocking=0`` resolves through
    it."""
    import os

    from heat3d_tpu_torch.serve.ensemble import EnsembleSolver
    from heat3d_tpu_torch.serve.scenario import Scenario, ScenarioBatch
    from heat3d_tpu_torch.tune.cli import main as tune_main

    assert tune_main(["run", "--grid", "12", "--batch-members", "4", "--device", "cpu",
                      "--knob", "time_blocking=1,2", "--steps", "2", "--repeats", "1",
                      "--json"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["key"].endswith("|b2^2") and res["cache_written"]
    entry = tcache.load()["entries"][res["key"]]
    assert entry["config"]["backend"] == "jnp"
    assert tune_main(["apply", "--grid", "12", "--batch-members", "4",
                      "--device", "cpu"]) == 0
    assert "--backend jnp" in capsys.readouterr().out
    base = _cfg(12, time_blocking=0)
    es = EnsembleSolver(ScenarioBatch(base, [Scenario(seed=m) for m in range(4)]),
                        device="cpu")
    assert es.cfg.time_blocking == entry["config"]["time_blocking"]
    assert os.environ.get(tcache.ENV_DISABLE) is None


def test_tune_apply_emits_flag_line(capsys):
    from heat3d_tpu_torch.tune.cli import main as tune_main

    _seed_entry(_cfg(12))
    assert tune_main(["apply", "--grid", "12", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert "--backend jnp" in line and "--time-blocking 2" in line
    assert tune_main(["apply", "--grid", "12", "--stencil", "27pt", "--device", "cpu"]) == 1


def test_tune_clear_and_lint_commands(capsys):
    from heat3d_tpu_torch.tune.cli import main as tune_main

    key, path = _seed_entry()
    assert tune_main(["lint"]) == 0
    assert tune_main(["clear", "--key", "nope"]) == 1
    assert tune_main(["clear", "--key", key]) == 0
    assert tcache.load()["entries"] == {}
    assert tune_main(["clear"]) == 2
    assert tune_main(["clear", "--all"]) == 0
    with open(path, "w") as f:
        f.write("{not json")
    assert tune_main(["lint"]) == 1


def test_regress_reports_tuned_configs():
    from heat3d_tpu_torch.obs.perf.regress import tune_notes

    assert tune_notes() == []
    _seed_entry()  # the winner flips time_blocking to 2
    notes = tune_notes()
    assert len(notes) == 1 and notes[0]["tuned"] == {"time_blocking": 2}


def test_regress_window_ignores_ancient_best_row():
    from heat3d_tpu.obs.perf import regress as jregress
    from heat3d_tpu_torch.obs.perf import regress

    def row(gcell, ts, platform="cpu"):
        return {"bench": "throughput", "ts": ts, "platform": platform,
                "grid": [32, 32, 32], "stencil": "7pt", "mesh": [1, 1, 1],
                "dtype": "float32", "compute_dtype": "float32", "backend": "auto",
                "time_blocking": 1, "overlap": False, "halo": "ppermute",
                "gcell_per_sec_per_chip": gcell}

    ancient, recent = row(100.0, "2024-01-01T00:00:00Z"), row(50.0, "2026-08-01T00:00:00Z")
    current = [row(49.0, "2026-08-02T00:00:00Z")]
    full = regress.compare(current, [ancient, recent])
    windowed = regress.compare(current, regress.filter_window([ancient, recent], 1))
    assert (full["verdict"], windowed["verdict"]) == ("fail", "pass")
    assert windowed["verdict"] == jregress.compare(
        current, jregress.filter_window([ancient, recent], 1))["verdict"]
    with pytest.raises(ValueError):
        regress.filter_window([recent], -2)


# ---- e2e: search -> store -> resolve, bitwise ------------------------------


def test_e2e_tune_run_writes_cache_solver_resolves_bitwise(tmp_path):
    """``tune run --device cpu`` at 16^3 over a 2-point space writes an
    entry ``lint`` accepts and ``show`` lists; a solver with auto knobs
    resolves through it (``tune_cache_hit``) and gives a result bitwise
    equal to the explicit config's."""
    from heat3d_tpu_torch.tune.cli import main as tune_main

    ledger = str(tmp_path / "led.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tune_main(["run", "--grid", "16", "--steps", "4", "--repeats", "1",
                        "--probe-steps", "0", "--budget-s", "120", "--knob",
                        "time_blocking=1,2", "--device", "cpu", "--ledger", ledger, "--json"])
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["platform"] == "cpu" and res["enumerate_s"] >= 0
    evs = _read(ledger)
    assert sum(1 for e in evs if e["event"] == "tune_trial"
               and e.get("status") == "measured") == 2
    assert [e for e in evs if e["event"] == "tune_winner"]
    rows = [e for e in evs if e["event"] == "bench_row"]
    assert rows and all(r["platform"] == "cpu" for r in rows)
    assert tune_main(["lint"]) == 0

    key = tcache.cache_key(_cfg(16), device="cpu")
    assert res["key"] == key
    entry = tcache.load()["entries"][key]
    assert entry["config"]["backend"] != "auto"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tune_main(["show"]) == 0
    assert key in out.getvalue() and "vs default" in out.getvalue()

    ledger2 = str(tmp_path / "led2.jsonl")
    obs.activate(ledger2)
    u0 = np.random.default_rng(3).standard_normal((16, 16, 16)).astype(np.float32)
    s_auto = HeatSolver3D(_cfg(16, backend="auto", halo="auto", time_blocking=0),
                          device="cpu")
    got_auto = s_auto.gather(s_auto.run(s_auto.init_state(u0), 7))
    obs.deactivate()
    hits = [e for e in _read(ledger2) if e["event"] == "tune_cache_hit"]
    assert hits and hits[0]["key"] == key
    c = entry["config"]
    s_static = HeatSolver3D(_cfg(16, backend=c["backend"], halo=c["halo"],
                                 overlap=c["overlap"], time_blocking=c["time_blocking"],
                                 halo_order=c["halo_order"]), device="cpu")
    got_static = s_static.gather(s_static.run(s_static.init_state(u0), 7))
    assert np.array_equal(got_auto, got_static)


def test_cli_resolves_before_run_start(tmp_path):
    """The solver command line resolves ``--time-blocking 0`` through the
    store before ``run_start``, which records the concrete tb; the auto
    flags are accepted."""
    from heat3d_tpu_torch.cli import main

    key = tcache.cache_key(_cfg(16), device="cpu")
    tcache.store_entry(key, _cfg(16, backend="pallas", time_blocking=2), 3.0)
    led = str(tmp_path / "led.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--grid", "16", "--steps", "5", "--time-blocking", "0", "--halo", "auto",
                     "--halo-plan", "auto", "--fused-rdma", "auto", "--device", "cpu",
                     "--ledger", led, "--golden-check"]) == 0
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert summary["time_blocking"] == 2 and summary["golden_pass"]
    evs = _read(led)
    names = [e["event"] for e in evs]
    assert names.index("tune_cache_hit") < names.index("run_start")
    start = next(e for e in evs if e["event"] == "run_start")
    assert (start["time_blocking"], start["halo"], start["halo_plan"],
            start["fused_rdma"]) == (2, "ppermute", "monolithic", "off")


def test_bench_command_resolves_its_config(monkeypatch):
    from heat3d_tpu_torch.bench import __main__ as bench_cli

    got = []
    monkeypatch.setattr(bench_cli, "bench_throughput", lambda cfg, steps, repeats, device:
                        got.append(cfg) or {"bench": "throughput"})
    assert bench_cli.main(["--grid", "16", "--device", "cpu", "--time-blocking", "0",
                           "--halo", "auto", "--bench", "throughput"]) == 0
    assert (got[0].time_blocking, got[0].halo) == (1, "ppermute")


def test_bench_throughput_on_an_explicit_cpu_device():
    """Only an explicit ``device='cpu'`` measures the CPU: a host-clock
    row that says so, never a device figure."""
    from heat3d_tpu_torch.bench.harness import bench_throughput

    row = bench_throughput(_cfg(12, time_blocking=2), steps=2, warmup=1, repeats=1,
                           device="cpu")
    assert row["platform"] == "cpu" and row["device_name"] == "cpu"
    assert row["sync_rtt_s"] == 0.0 and row["rtt_dominated"] is False
    assert row["gcell_per_sec_per_chip"] > 0
