"""The port's serving model and autoscaler against the JAX package's, exactly.

``serve.metrics``' weighted quantile, ``serve.requests``' window generators,
spec derivation and ``serve_trace``, ``serve.tenant``'s slice model
(``request_times``, ``split_slice``, ``window_stats``,
``required_replicas``) and ``serve.autoscale``'s decisions are copies of
plain-Python modules of the JAX package, and so is the engine that serves
the windows. Every case runs the same inputs through both packages in this
one process and compares the results as plain data (exceptions by type name
and message), ending with ``chip_smoke.py``'s phase 14(e) serving runs: the
autoscaler against static provisioning on a diurnal and a bursty day.

No case draws at random: every input is enumerated or seeded.
"""

import importlib.util
import pathlib
import types

import pytest

from repro import sim as jsim  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import health as jhealth  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.serve import autoscale as jautoscale  # noqa: E402
from repro.serve import metrics as jmetrics  # noqa: E402
from repro.serve import requests as jrequests  # noqa: E402
from repro.serve import tenant as jtenant  # noqa: E402
from repro.sim import workload as jworkload  # noqa: E402
from repro_torch import sim as tsim  # noqa: E402
from jax_twin import twin_config  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import health as thealth  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.serve import autoscale as tautoscale  # noqa: E402
from repro_torch.serve import metrics as tmetrics  # noqa: E402
from repro_torch.serve import requests as trequests  # noqa: E402
from repro_torch.serve import tenant as ttenant  # noqa: E402
from repro_torch.sim import workload as tworkload  # noqa: E402

from test_torch_rack import _plain, _try  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

J = types.SimpleNamespace(sim=jsim, workload=jworkload, requests=jrequests, tenant=jtenant,
                          autoscale=jautoscale, health=jhealth, cm=jcm, sch=jsch,
                          metrics=jmetrics, get_config=jax_get_config)
T = types.SimpleNamespace(sim=tsim, workload=tworkload, requests=trequests, tenant=ttenant,
                          autoscale=tautoscale, health=thealth, cm=tcm, sch=tsch,
                          metrics=tmetrics, get_config=twin_config)
SEEDS = (0, 5)
WINDOWS = dict(horizon_s=3600.0, window_s=60.0, base_rate=4.0, peak_rate=40.0,
               prompt_tokens=1024.0, output_tokens=256.0)
#: a TP=4 serving profile and a TP=1 one
PROFILES = (chip_smoke.RACK_SERVE_PROFILE,
            dict(model="small", tp=1, buckets=(4e6,), algos=("ring",), compute_scale=0.8))
ARCHS = ("h2o-danube-1.8b", "deepseek-v2-lite-16b", "zamba2-1.2b", "xlstm-125m", "dbrx-132b")


def _both(scenario):
    j, t = _plain(scenario(J)), _plain(scenario(T))
    assert t == j
    return t


def _profile(m, i):
    return m.workload.CollectiveProfile(**PROFILES[i])


def _spec_of(m, i, pattern="diurnal", seed=0):
    gen = m.requests.diurnal_windows if pattern == "diurnal" else m.requests.bursty_windows
    return m.requests.serving_spec_from_profile(_profile(m, i), gen(**WINDOWS, seed=seed),
                                                slo_ttft_s=1.0, slo_tpot_s=0.05)


def _prices(m):
    return m.tenant.SlicePrices(tp_prefill_s=2e-4, tp_decode_s=3e-5, kv_base_s=4e-6,
                                kv_per_byte_s=2e-11)


def test_metric_names_and_weighted_quantile():
    def run(m):
        names = {k: getattr(m.metrics, k) for k in dir(m.metrics) if k.isupper()}
        cases = [[], [(0.0, 1.0)], [(1.0, 3.0)], [(2.0, 5.0), (1.0, 1.0), (3.0, 2.0)],
                 [(1.0, v) for v in (0.3, 0.1, 0.2, 0.9, 0.5)], [(1e9, 2.0), (1.0, 99.0)]]
        return names, [[m.metrics.weighted_quantile(c, q) for q in (0.0, 0.5, 0.99, 1.0)]
                       for c in cases]
    _both(run)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pattern", ["diurnal", "bursty"])
def test_load_windows(pattern, seed):
    def run(m):
        if pattern == "diurnal":
            return (m.requests.diurnal_windows(**WINDOWS, seed=seed),
                    m.requests.diurnal_windows(**WINDOWS, seed=seed, phase=1.3, day_s=1800.0))
        return (m.requests.bursty_windows(**WINDOWS, seed=seed),
                m.requests.bursty_windows(horizon_s=7200.0, window_s=60.0, base_rate=8.0,
                                          prompt_tokens=2048.0, output_tokens=256.0, seed=seed,
                                          p_burst=0.25, mean_burst_windows=3.0, burst_mult=3.0))
    _both(run)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_spec_from_configs(arch):
    def run(m):
        windows = m.requests.diurnal_windows(**WINDOWS, seed=1)
        return (m.requests.serving_spec(m.get_config(arch), windows),
                m.requests.serving_spec(m.get_config(arch), windows, tp=2, decode_batch=8))
    _both(run)


def test_serving_spec_from_profiles():
    def run(m):
        out = [_spec_of(m, i, p) for i in range(len(PROFILES)) for p in ("diurnal", "bursty")]
        out.append(_try(m.workload.ServeSpec, windows=()))
        out.append(_try(m.workload.ServeSpec, windows=out[0].windows, slo_ttft_s=0.0))
        return out
    _both(run)


@pytest.mark.parametrize("pattern", ["diurnal", "bursty"])
def test_serve_trace(pattern):
    def run(m):
        profs = [_profile(m, 0), _profile(m, 1)]
        out = [m.requests.serve_trace(3, profs, pattern=pattern, seed=s, train_jobs=4)
               for s in SEEDS]
        out.append(m.requests.serve_trace(2, profs[:1], pattern=pattern, chips=(12, 20)))
        out.append([t.to_jsonl() for t in out])
        out += [_try(m.requests.serve_trace, 1, []),
                _try(m.requests.serve_trace, 1, profs, pattern="weekly")]
        return out
    _both(run)


@pytest.mark.parametrize("i", range(len(PROFILES)))
def test_slice_model(i):
    def run(m):
        spec, prof, prices = _spec_of(m, i), _profile(m, i), _prices(m)
        t = m.tenant
        out = [t.granularity(prof), t.granularity(None), t.mean_lengths(spec),
               prices.kv_time(0.0), prices.kv_time(1e8)]
        for prompt, output in ((128.0, 16.0), (2048.0, 256.0), (8192.0, 1024.0)):
            out.append((t.prefill_time(spec, prof, prompt, prices),
                        t.decode_step_time(spec, prof, output, prices),
                        t.request_times(spec, prof, prompt, output, prices)))
        for n in (1, 2, 3, 8, 17):
            out.append(_try(t.split_slice, spec, prof, n, prices))
        for rate in (0.5, 4.0, 40.0):
            for rho in (0.5, 0.7, 0.9):
                out.append(t.required_replicas(spec, prof, prices, rate=rate, rho_target=rho))
        out.append(t.required_replicas(spec, None, prices, rate=4.0, prompt=512.0, output=32.0))
        for w in spec.windows[::7]:
            for n_pf, n_dec in ((1, 1), (2, 5), (6, 3)):
                out.append(t.window_stats(spec, prof, w, n_pf, n_dec, prices))
                out.append(t.window_stats(spec, prof, w, n_pf, n_dec, prices, lost_s=5.0,
                                          q0=300.0))
        return out
    _both(run)


def test_autoscaler_decisions():
    """The decisions over a day of windows, the replicas and the calm counter
    threaded through as the engine threads them."""
    def run(m):
        spec, prof, prices = _spec_of(m, 0, "bursty", seed=3), _profile(m, 0), _prices(m)
        out = []
        for cfg in (m.autoscale.AutoscaleConfig(),
                    m.autoscale.AutoscaleConfig(max_step_up=8, down_windows=3,
                                                shrink_headroom=0.6)):
            scaler = m.autoscale.Autoscaler(cfg)
            n, calm, prev, q = 2, 0, None, 0.0
            for w in spec.windows:
                n_pf, n_dec = m.tenant.split_slice(spec, prof, n, prices)
                stats = m.tenant.window_stats(spec, prof, w, n_pf, n_dec, prices, q0=q)
                q = stats.queue_carry
                n, calm = scaler.decide(n, stats, calm, prev)
                prev = max(stats.rho_prefill, stats.rho_decode) * stats.capacity_frac
                out.append((n, calm))
        return out
    decisions = _both(run)
    assert len({n for n, _ in decisions}) > 2  # the autoscaler grew and shrank


# ---------------------------------------------------------------------------
# the engine: phase 14(e)'s serving runs
# ---------------------------------------------------------------------------

_TRACES = {}


def _traces(m):
    key = "jax" if m is J else "port"
    if key not in _TRACES:
        _TRACES[key] = chip_smoke.rack_traces(m)
    return _TRACES[key]


SERVE_RUNS = [n for n in chip_smoke.rack_runs(T, {}) if n.startswith("serve_")]


@pytest.mark.parametrize("name", SERVE_RUNS)
def test_serving_engine_runs_match(name):
    def run(m):
        traces = _traces(m)
        trace, sim = chip_smoke.rack_runs(m, traces)[name]
        before = m.sch.transfer_tables_built()
        metrics = sim(traces[trace])
        return (chip_smoke.rack_record(metrics), metrics.serve_summary(),
                m.sch.transfer_tables_built() - before)
    record, serve, _ = _both(run)
    assert serve["slo_attainment"] > 0 and record["events"] > 0
    if name.endswith("/auto"):
        assert serve["scale_ups"] > 0 and serve["scale_downs"] > 0
