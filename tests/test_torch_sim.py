"""The port's rack simulator against the JAX package's, exactly.

The trace generators and their JSONL format, the fabric health model, the
SiPAC emulation, the discrete-event engine and the scenario sweep are
copies of plain-Python modules of the JAX package. Every case runs the same
inputs through both packages in this one process and compares the results
as plain data (exceptions by type name and message): each spec, trace line,
price and ``SimMetrics`` field must be the reference's to the bit.

The engine cases are ``chip_smoke.py``'s phase 14(e) runs at their sizes
(Fig 2a, sim_rack's Poisson trace, the morph churn, the pod churn, the chaos
and glitch-storm traces, the golden fixtures), built by each package's own
generators; the serving runs are in ``tests/test_torch_serve_sim.py``.

No case draws at random: every input is enumerated or seeded.
"""

import importlib.util
import json
import pathlib
import types

import numpy as np
import pytest

from repro import sim as jsim  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import health as jhealth  # noqa: E402
from repro.core import rack as jrack  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.core import sipac as jsipac  # noqa: E402
from repro.serve import autoscale as jautoscale  # noqa: E402
from repro.serve import requests as jrequests  # noqa: E402
from repro.serve import tenant as jtenant  # noqa: E402
from repro.sim import workload as jworkload  # noqa: E402
from repro import sweep as jsweep  # noqa: E402
from repro_torch import sim as tsim  # noqa: E402
from repro_torch import sweep as tsweep  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import health as thealth  # noqa: E402
from repro_torch.core import rack as track  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.core import sipac as tsipac  # noqa: E402
from repro_torch.serve import autoscale as tautoscale  # noqa: E402
from repro_torch.serve import requests as trequests  # noqa: E402
from repro_torch.serve import tenant as ttenant  # noqa: E402
from repro_torch.sim import workload as tworkload  # noqa: E402

from test_torch_rack import _plain, _try  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

J = types.SimpleNamespace(sim=jsim, workload=jworkload, requests=jrequests, tenant=jtenant,
                          autoscale=jautoscale, health=jhealth, cm=jcm, rack=jrack,
                          sipac=jsipac, sch=jsch, sweep=jsweep)
T = types.SimpleNamespace(sim=tsim, workload=tworkload, requests=trequests, tenant=ttenant,
                          autoscale=tautoscale, health=thealth, cm=tcm, rack=track,
                          sipac=tsipac, sch=tsch, sweep=tsweep)
SEEDS = (0, 7)
#: two hand-made profiles for the zoo generator: a TP=2 model with buckets and
#: an activation stream, and a TP=1 one
PROFILES = (dict(model="a", tp=2, buckets=(8e6, 8e6, 4e6), algos=("ring", "lumorph2", "ring"),
                 tp_bytes=4e6, tp_collectives=8, compute_scale=1.5),
            dict(model="b", tp=1, buckets=(2e6,), algos=("lumorph4",), compute_scale=0.5))


def _both(scenario):
    j, t = _plain(scenario(J)), _plain(scenario(T))
    assert t == j
    return t


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def _profiles(m):
    return [m.workload.CollectiveProfile(**p) for p in PROFILES]


def _chaos(m, seed):
    return m.workload.chaos_trace(120, n_chips=64, tiles_per_server=8, link_fail_rate=0.05,
                                  trx_fail_rate=0.02, degrade_rate=0.02, max_fibers_cut=2,
                                  derate=2.0, mttr=30.0, seed=seed)


GENERATORS = {
    "fig2a": lambda m, s: m.workload.fig2a_trace(300, failure_rate=0.02, n_chips=64, seed=s),
    "fig2a_default": lambda m, s: m.workload.fig2a_trace(seed=s),
    "poisson": lambda m, s: m.workload.poisson_trace(
        100, arrival_rate=0.4, mean_steps=12.0, failure_rate=0.01, n_chips=64, seed=s),
    "poisson_fig2a_sizes": lambda m, s: m.workload.poisson_trace(
        80, size_sampler=m.workload.fig2a_size_sampler, coll_bytes=float(1 << 22), seed=s),
    "pod_churn": lambda m, s: m.workload.pod_churn_trace(
        100, n_chips=128, chips_per_rack=64, failure_rate=0.01, seed=s),
    "zoo": lambda m, s: m.workload.zoo_trace(60, _profiles(m), n_chips=64, failure_rate=0.02,
                                             seed=s),
    "zoo_stripped": lambda m, s: m.workload.strip_profiles(
        m.workload.zoo_trace(40, _profiles(m), seed=s)),
    "failure_injection": lambda m, s: m.workload.failure_injection_trace(n_chips=64, seed=s),
    "chaos": _chaos,
    "glitch_storm": lambda m, s: m.workload.glitch_storm_trace(60, n_chips=64, glitch_every=6.0,
                                                               glitch_duration=3.0, seed=s),
    "fail_stop": lambda m, s: m.workload.fail_stop_trace(_chaos(m, s), tiles_per_server=8),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_trace_generators(gen, seed):
    """Equal specs and byte-identical JSONL, and the JSONL loads back."""
    def run(m):
        trace = GENERATORS[gen](m, seed)
        text = trace.to_jsonl()
        return trace, text, m.sim.Trace.from_jsonl(text) == trace
    trace, text, round_trip = _both(run)
    assert round_trip


@pytest.mark.parametrize("seed", SEEDS)
def test_size_samplers(seed):
    def run(m):
        rng = np.random.RandomState(seed)
        out = [m.workload.fig2a_size_sampler(rng) for _ in range(100)]
        out += [m.workload.heavy_tailed_size_sampler(rng) for _ in range(100)]
        out += [m.workload.heavy_tailed_size_sampler(rng, n_chips=128) for _ in range(50)]
        return out
    _both(run)


def test_jax_written_trace_loads_in_the_port(tmp_path):
    jtrace = jworkload.chaos_trace(60, seed=3)
    jtrace.save(tmp_path / "chaos.jsonl")
    ttrace = tworkload.Trace.load(tmp_path / "chaos.jsonl")
    assert _plain(ttrace) == _plain(jtrace)
    assert ttrace.to_jsonl() == (tmp_path / "chaos.jsonl").read_text()
    for name in ("trace_0", "trace_1"):
        raw = (ROOT / "tests" / "golden" / f"{name}.jsonl").read_text()
        ttrace = tworkload.Trace.from_jsonl(raw)
        assert ttrace.to_jsonl() == raw
        assert _plain(ttrace) == _plain(jworkload.Trace.from_jsonl(raw))


def test_spec_validation_errors():
    def run(m):
        w = m.workload
        return [_try(w.CollectiveProfile, model="x", tp=0),
                _try(w.CollectiveProfile, model="x", buckets=(0.0,)),
                _try(w.JobSpec, "t", 0.0, 0),
                _try(w.FailureSpec, 1.0, (), kind="bogus"),
                _try(w.FailureSpec, 1.0, (3,), kind="degrade", derate=0.5),
                _try(w.LoadWindow, start=0.0, duration=0.0, requests=1, prompt_tokens=1.0,
                     output_tokens=1.0),
                _try(w.zoo_trace, 3, []),
                _try(w.Trace.from_jsonl, '{"type": "nothing"}\n')]
    _both(run)


# ---------------------------------------------------------------------------
# fabric health and SiPAC
# ---------------------------------------------------------------------------

def _health_state(h):
    return (bool(h), h.epoch, h.mzi_failed, h.fibers_lost((1, 0)), h.fibers_lost((2, 3)),
            h.lanes_lost(5), h.rails_lost((0, 1)), h.derate_of(5), h.worst_derate(range(8)),
            h.unusable_chips(4), h.active_glitch(2.5), h.degraded_overlap(0.0, 10.0))


def test_fabric_health_state_sequence():
    def run(m):
        h = m.health.FabricHealth()
        out = [_health_state(h)]
        for op, args in [("fail_fibers", ((0, 1), 2)), ("fail_fibers", ((1, 0),)),
                         ("repair_fibers", ((0, 1),)), ("repair_fibers", ((0, 1),)),
                         ("fail_lanes", (5, 4)), ("repair_lanes", (5,)),
                         ("fail_rails", ((1, 0), 3)), ("set_derate", (5, 2.0)),
                         ("set_derate", (6, 4.0)), ("set_derate", (5, 1.0)),
                         ("set_derate", (5, 0.5)), ("clear_derate", (6,)),
                         ("repair_rails", ((0, 1),)), ("start_glitch", (2.0, 4.0, 0.5)),
                         ("start_glitch", (1.0, 3.0, 0.9, (1, 0))),
                         ("start_glitch", (3.0, 3.0, 0.5)), ("start_glitch", (1.0, 2.0, 0.0)),
                         ("escalate_ocs", ((0, 1), 2)), ("escalate_ocs", (None,)),
                         ("repair_ocs", ((0, 1),)), ("repair_ocs", ()),
                         ("start_glitch", (6.0, 9.0, 0.25)), ("start_glitch", (8.0, 12.0, 0.5))]:
            out.append((op, _try(getattr(h, op), *args), _health_state(h)))
        return out
    _both(run)


def test_ocs_retry_policy():
    def run(m):
        out = []
        for kw in ({}, dict(max_retries=3, backoff_s=1e-3, multiplier=1.0),
                   dict(max_retries=8, backoff_s=5e-6, multiplier=3.0)):
            p = m.health.OCSRetryPolicy(**kw)
            out.append((p.total_backoff_s,
                        [(p.expected_retries(q), p.expected_delay(q))
                         for q in (-0.5, 0.0, 0.1, 0.5, 0.99, 1.0, 2.0)]))
        out += [_try(m.health.OCSRetryPolicy, max_retries=0),
                _try(m.health.OCSRetryPolicy, backoff_s=0.0),
                _try(m.health.OCSRetryPolicy, multiplier=0.5)]
        return out
    _both(run)


@pytest.mark.parametrize("r,ell", [(2, 3), (3, 2)])
def test_sipac_emulation_and_cost(r, ell):
    def run(m):
        rack = m.rack.default_rack(n_chips=64, tiles_per_server=8, fibers_per_server_pair=64)
        chips = tuple(range(8, 8 + r ** ell))
        pairs = m.sipac.configure_sipac_on_lumorph(rack, chips, r, ell)
        return (m.sipac.sipac_edges(r, ell), pairs, m.sipac.emulation_is_exact(rack, chips, r, ell),
                sorted(m.sipac.sipac_graph(r, ell).edges()),
                [m.sipac.flex_sipco_cost(n, r, ell, link)
                 for n in (1e3, 4e6, 1e9) for link in (m.cm.LUMORPH_LINK, m.cm.IDEAL_SWITCH)],
                _try(m.sipac.configure_sipac_on_lumorph, rack, chips[:-1], r, ell))
    assert _both(run)[2] is True


def test_sipac_refused_at_4_2():
    def run(m):
        rack = m.rack.default_rack(n_chips=64, tiles_per_server=8, fibers_per_server_pair=64)
        return _try(m.sipac.configure_sipac_on_lumorph, rack, tuple(range(16)), 4, 2)
    got = _both(run)
    assert got[:2] == ("raised", "CircuitError")
    assert "chip 0 needs 6 TX circuits > 4 TRX banks" in got[2]


# ---------------------------------------------------------------------------
# the engine: phase 14(e)'s runs
# ---------------------------------------------------------------------------

_TRACES = {}


def _traces(m):
    key = "jax" if m is J else "port"
    if key not in _TRACES:
        _TRACES[key] = chip_smoke.rack_traces(m)
    return _TRACES[key]


ENGINE_RUNS = [n for n in chip_smoke.rack_runs(T, {}) if not n.startswith("serve_")]


def run_engine(m, name):
    """One phase 14(e) run: every field of its metrics, its summary, and the
    Transfer tables the package built during it."""
    traces = _traces(m)
    trace, run = chip_smoke.rack_runs(m, traces)[name]
    before = m.sch.transfer_tables_built()
    metrics = run(traces[trace])
    return (chip_smoke.rack_record(metrics), metrics.summary(),
            m.sch.transfer_tables_built() - before)


@pytest.mark.parametrize("name", ENGINE_RUNS)
def test_engine_runs_match(name):
    record, summary, _ = _both(lambda m: run_engine(m, name))
    assert record["events"] > 0
    if name.startswith("golden/"):
        fixture = ROOT / "tests" / "golden" / f"{name.split('/')[1]}.json"
        assert summary == json.loads(fixture.read_text())


def test_phase_traces_match():
    """Every trace phase 14(e) replays, the serving ones included."""
    j, t = _traces(J), _traces(T)
    assert sorted(j) == sorted(t)
    for name in j:
        assert _plain(t[name]) == _plain(j[name]), name
        assert t[name].to_jsonl() == j[name].to_jsonl(), name


def test_engine_helpers_and_whatif():
    def run(m):
        trace = m.workload.fig2a_trace(80, failure_rate=0.02, n_chips=64, seed=1)
        sims = [m.sim.RackSimulator(kind, trace, n_chips=64) for kind in ("lumorph", "torus")]
        out = [m.sim.make_discipline("sipac"), _try(m.sim.make_discipline, "mesh")]
        for s in sims:
            s.run(max_events=40)
            out.append([_try(s.whatif, k) for k in (1, 3, 8, 12, 30)])
        res = m.sim.compare(trace, n_chips=64, morph=True)
        out.append({k: v.summary() for k, v in res.items()})
        out.append(m.sim.simulate("lumorph", trace, n_chips=64, policy="locality").summary())
        out.append(m.sim.simulate("lumorph", trace, n_chips=64, policy="future-morph",
                                  morph=True).csv_rows("x"))
        return out
    _both(run)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _sweep_profiles(m):
    return tuple(m.workload.CollectiveProfile(**p) for p in PROFILES)


def _grid(m):
    return m.sweep.sweep_grid(seeds=(0, 1), disciplines=("lumorph", "torus"),
                              fabrics=((64, 1),), workloads=("zoo", "zoo-generic", "serve"),
                              morphs=(False, True), autoscales=(False, True), n_jobs=10)


def _untimed(results):
    return [{k: v for k, v in r.items() if k != "timing"} for r in results]


def test_sweep_serial_matches_jax():
    def run(m):
        results = m.sweep.run_sweep(_grid(m), jobs=1, profiles=_sweep_profiles(m))
        return _untimed(results), m.sweep.pareto_report(results)
    _both(run)


def _outcomes(results):
    """What a sweep decides, without the pricer's cache statistics (which
    follow how the warm pool was shared among workers)."""
    return [{k: r.get(k) for k in ("scenario", "policy", "workload_class", "summary", "serve")}
            for r in results]


def test_sweep_two_workers_match_serial():
    grid = _grid(T)
    serial = tsweep.run_sweep(grid, jobs=1, profiles=_sweep_profiles(T))
    parallel = tsweep.run_sweep(grid, jobs=2, profiles=_sweep_profiles(T))
    assert _outcomes(parallel) == _outcomes(serial)
    assert [r["pricing"]["transfers_materialized"] for r in parallel] == [0] * len(grid)
