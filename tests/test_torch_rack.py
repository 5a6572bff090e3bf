"""The port's rack substrate against the JAX package's, exactly.

The fabric, rack and pod models, the scheduler's rack pricing, validation,
fiber and rail demand, locality order and candidate algorithms, the
schedule pricer, the placement policies, the allocators and the fault
tolerance runtime (the morph failure bypass included) are copies of
plain-Python modules of the JAX package. Every case here runs the same
scenario on both packages and compares the results as plain data (exceptions by type name and message), so every
number, chip set and error must be the reference's to the bit. One case is
reference fault (b): ``requests=[1, 5, 12]`` under ``future-morph`` places
the 12-chip tenant on chips 6–17 at 424.0 µs, below the 429.2 µs of the
"ideal" ``range(12)``, in both packages (a copied quirk).

No case draws at random: every input is enumerated.
"""

import dataclasses
import types

import numpy as np
import pytest

from repro.core import allocator as jalloc  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import fabric as jfab  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import pricing as jpricing  # noqa: E402
from repro.core import rack as jrack  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro_torch.core import allocator as talloc  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import fabric as tfab  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import pricing as tpricing  # noqa: E402
from repro_torch.core import rack as track  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.runtime import fault_tolerance as tft  # noqa: E402

J = types.SimpleNamespace(alloc=jalloc, cm=jcm, fab=jfab, policy=jpolicy, pricing=jpricing,
                          rack=jrack, sch=jsch, ft=jft)
T = types.SimpleNamespace(alloc=talloc, cm=tcm, fab=tfab, policy=tpolicy, pricing=tpricing,
                          rack=track, sch=tsch, ft=tft)
ALGOS = ("ring", "lumorph2", "lumorph4")
TILES = 8


def _plain(x):
    """Results as plain, comparable data (a Schedule as its rounds' circuits)."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.tolist())
    if isinstance(x, (jsch.Schedule, tsch.Schedule)):
        return ("Schedule", x.algo, x.participants, x.n_bytes, x.n_chunks,
                tuple((r.pairs, r.bytes_per_circuit, r.egress_fanout, r.tier, r.reduce)
                      for r in x.rounds))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(x)))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return x


def _try(fn, *args, **kwargs):
    try:
        return ("ok", _plain(fn(*args, **kwargs)))
    except Exception as e:  # compared by type name and message
        return ("raised", type(e).__name__, str(e))


def _both(scenario):
    j, t = _plain(scenario(J)), _plain(scenario(T))
    assert t == j
    return t


# ---------------------------------------------------------------------------
# fabric and rack
# ---------------------------------------------------------------------------

ROUNDS = [
    [(0, 1), (1, 0)],
    [(0, 8), (1, 9), (2, 10), (3, 11)],
    [(c, c + 8) for c in range(8)] + [(c + 8, c) for c in range(8)],
    [(0, 1), (0, 2), (0, 3), (0, 4), (0, 5)],  # one tile's TX banks overrun
    [(1, 0), (2, 0), (3, 0), (4, 0), (5, 0)],  # RX banks overrun
    [(0, 63), (63, 0), (7, 56)],
    [(c, (c + 16) % 64) for c in range(0, 64, 2)],
]


@pytest.mark.parametrize("fibers", [1, 2, 8, 32])
def test_validate_and_feasible_rounds(fibers):
    def run(m):
        rack = m.rack.default_rack(n_chips=64, tiles_per_server=TILES,
                                   fibers_per_server_pair=fibers)
        out = []
        for pairs in ROUNDS:
            out.append(_try(rack.validate_round, pairs))
            out.append(_try(rack.validate_round, np.asarray(pairs), check_fibers=False))
            out.append(_try(rack.feasible_round, pairs))
        return out, rack.n_chips, rack.server_of(37), rack.tile_of(37)
    _both(run)


def test_establish_teardown_reconfigure():
    def run(m):
        rack = m.fab.LumorphRack(n_servers=4, tiles_per_server=4, trx_banks_per_tile=2,
                                 fibers_per_server_pair=2)
        log = []
        made = []
        for src, dst in [(0, 1), (0, 2), (0, 3), (4, 8), (5, 9), (6, 10), (1, 1), (3, 20)]:
            r = _try(rack.establish, src, dst)
            log.append(r)
            if r[0] == "ok":
                made.append(rack.live_circuits()[-1])
        for c in made[:2]:
            rack.teardown(c)
        log.append(len(rack.live_circuits()))
        log.append(_try(lambda: [(c.src, c.dst) for c in rack.reconfigure(
            [(0, 5), (1, 6), (2, 7), (12, 13)])]))
        log.append((rack.reconfig_events, rack.reconfig_time))
        fab = m.fab.LightpathFabric(n_tiles=4, trx_banks_per_tile=1)
        log.append(_try(fab.alloc_endpoint, 0, 1))
        log.append(_try(fab.alloc_endpoint, 0, 2))
        log.append((fab.tx_free(0), fab.rx_free(1)))
        fab.release_endpoint(0, 1, 0)
        log.append((fab.tx_free(0), fab.rx_free(1)))
        log.append(m.fab.peak_pair_multiplicity(np.array([0, 1, 0, 2, 1]),
                                                np.array([1, 0, 1, 3, 0])))
        log.append(m.fab.peak_multiplicity(np.array([3, 3, 1, 3, 2])))
        return log
    _both(run)


def test_pod_geometry_and_rails():
    def run(m):
        pod = m.rack.Pod(n_racks=2, chips_per_rack=32, tiles_per_server=TILES,
                         rails_per_rack_pair=2)
        out = [pod.n_chips, pod.rack_of(40), pod.server_of(40), pod.tile_of(40),
               _try(pod.validate_round, [(0, 32), (1, 33), (2, 34)]),
               _try(pod.validate_round, [(0, 32), (1, 33), (2, 34)], check_fibers=False),
               _try(pod.validate_round, [(0, 1), (33, 34)]),
               _try(pod.feasible_round, [(0, 32), (1, 33)]),
               _try(pod.establish, 0, 33), _try(pod.establish, 1, 34),
               _try(pod.establish, 2, 35),
               pod.reconfig_window([0, 1, 40], 1e-6),
               m.rack.group_by_rack([70, 3, 40, 64, 1], 32),
               _try(m.rack.Pod, n_racks=0), _try(m.rack.Pod, chips_per_rack=30)]
        big = m.rack.default_pod(n_racks=3, chips_per_rack=64)
        out.append((big.n_racks, big.chips_per_rack, big.rails_per_rack_pair))
        return out
    _both(run)


# ---------------------------------------------------------------------------
# scheduler: rack pricing, validation, demand, locality, candidates
# ---------------------------------------------------------------------------

CHIP_SETS = [tuple(range(8)), tuple(range(16)), (0, 1, 2, 8, 9, 10, 16, 17),
             (3, 11, 19, 27, 35, 43, 51, 59), tuple(range(0, 64, 4)),
             (5, 6, 7, 8, 9, 10), tuple(range(32, 64))]


@pytest.mark.parametrize("chips", CHIP_SETS, ids=lambda c: f"{len(c)}chips-{c[0]}")
def test_rack_prices_validation_and_demand(chips):
    def run(m):
        rack = m.rack.default_rack(n_chips=64, tiles_per_server=TILES,
                                   fibers_per_server_pair=4)
        ordered = m.sch.order_for_locality(chips, tiles_per_server=TILES)
        out = [ordered]
        for algo in ("ring", "lumorph2", "lumorph4", "tree"):
            for cs in (chips, tuple(ordered)):
                s = m.sch.build_schedule(algo, cs, 8 << 20)
                out += [_try(s.validate, rack), _try(s.validate, rack, check_fibers=False),
                        s.cost(m.cm.LUMORPH_LINK, rack), s.cost_by_tier(m.cm.LUMORPH_LINK, rack),
                        m.sch.fiber_demand(s, TILES), s.reconfigurations()]
                ch = m.sch.chunk_schedule(s, 3)
                out += [_try(ch.validate, rack), ch.cost(m.cm.LUMORPH_LINK, rack),
                        ch.overlapped_cost(m.cm.LUMORPH_LINK, rack, compute_s=2e-4)]
        return out
    _both(run)


@pytest.mark.parametrize("chips", [tuple(range(8)) + tuple(range(64, 72)),
                                   tuple(range(0, 16)) + tuple(range(64, 80)),
                                   (0, 1, 64, 65, 66), tuple(range(60, 68))],
                         ids=["8+8", "16+16", "2+3", "straddle"])
def test_pod_prices_hierarchical_and_candidates(chips):
    def run(m):
        pod = m.rack.Pod(n_racks=2, chips_per_rack=64, tiles_per_server=TILES)
        ordered = tuple(m.sch.order_for_locality(chips, TILES, chips_per_rack=64))
        cands = m.sch.candidate_algos(ALGOS + ("tree",), ordered, 64)
        out = [ordered, cands, m.sch.candidate_algos(ALGOS, ordered)]
        for algo in cands:
            r = _try(m.sch.build_any_schedule, algo, ordered, 4 << 20, chips_per_rack=64)
            out.append(r[0])
            if r[0] != "ok":
                out.append(r)
                continue
            s = m.sch.build_any_schedule(algo, ordered, 4 << 20, chips_per_rack=64)
            out += [s.cost(m.cm.LUMORPH_LINK, pod), s.cost_by_tier(m.cm.LUMORPH_LINK, pod),
                    _try(s.validate, pod), _try(s.validate, pod, check_fibers=False),
                    m.sch.fiber_demand(s, TILES, chips_per_rack=64),
                    m.sch.rail_demand(s, 64), len(s.rounds)]
        out.append(_try(m.sch.hierarchical_schedule, (0, 1, 64), 1e6, 64))
        out.append(_try(m.sch.build_any_schedule, "hier:ring", (0, 1), 1e6))
        return out
    _both(run)


# ---------------------------------------------------------------------------
# the schedule pricer
# ---------------------------------------------------------------------------

def test_schedule_pricer_on_a_rack_and_a_pod():
    def run(m):
        rack = m.fab.LumorphRack(n_servers=8, tiles_per_server=TILES)
        pod = m.rack.Pod(n_racks=2, chips_per_rack=64, tiles_per_server=TILES)
        out = []
        for fabric, cpr in ((rack, None), (pod, 64)):
            pr = m.pricing.SchedulePricer(m.cm.LUMORPH_LINK, rack=fabric,
                                          tiles_per_server=TILES, chips_per_rack=cpr)
            for chips in [(0, 1, 2, 3), (0, 1, 8, 9), tuple(range(16)), (8, 9, 10, 11),
                          tuple(range(0, 8)) + tuple(range(64, 72)) if cpr else (5, 13, 21)]:
                algos = m.sch.candidate_algos(ALGOS, chips, cpr)
                out += [pr.cheapest(algos, chips, 64 << 20),
                        [pr.price(a, chips, 1 << 20) for a in algos],
                        [pr.lower_bound(a, chips, 1 << 20) for a in algos],
                        pr.cache_key_chips(chips),
                        m.pricing.canonical_layout(chips, TILES, cpr)]
            out.append((len(pr), pr.stats.hits, pr.stats.misses))
        return out
    _both(run)


# ---------------------------------------------------------------------------
# placement policies and allocators
# ---------------------------------------------------------------------------

REQUEST_SEQUENCES = [
    [1, 5, 12],  # reference fault (b)'s case
    [8, 8, 8, 3, -1, 5, 7, -1, 16],
    [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, -1, -1, 6],
    [20, 13, -1, 9, 9],
    [40, 1],
]


def _rack_pricer(m, n_servers=4):
    return m.pricing.SchedulePricer(m.cm.LUMORPH_LINK,
                                    rack=m.fab.LumorphRack(n_servers=n_servers,
                                                           tiles_per_server=TILES),
                                    tiles_per_server=TILES)


@pytest.mark.parametrize("placement", ["packing", "locality", "future-morph"])
@pytest.mark.parametrize("seq", range(len(REQUEST_SEQUENCES)))
def test_whatif_and_allocate_sequences(placement, seq):
    """The test_policy.py property's scenario, on fixed request sequences
    (-1 releases the oldest live tenant): verdicts, chip sets, prices and
    stretches equal JAX's."""
    def run(m):
        a = m.alloc.LumorphAllocator(32, tiles_per_server=TILES, policy=placement)
        a.policy.bind(_rack_pricer(m), ALGOS)
        live, out = [], []
        for i, k in enumerate(REQUEST_SEQUENCES[seq]):
            if k == -1:
                if live:
                    a.release(live.pop(0))
                continue
            v = a.whatif(k)
            out.append((v.admitted, v.chips, v.step_s, v.ideal_s, v.reason, v.stretch))
            got = _try(a.allocate, f"t{i}", k)
            out.append(got)
            if got[0] == "ok":
                live.append(f"t{i}")
        return out, sorted(a.free)
    _both(run)


def test_reference_fault_b_is_copied():
    """Under future-morph the 12-chip tenant lands on chips 6–17 at 424.0 µs,
    below the ideal layout's 429.2 µs: stretch < 1 in both packages."""
    def run(m):
        a = m.alloc.LumorphAllocator(32, tiles_per_server=TILES, policy="future-morph")
        a.policy.bind(_rack_pricer(m), ALGOS)
        a.allocate("t0", 1)
        a.allocate("t1", 5)
        v = a.whatif(12)
        return v.chips, round(v.step_s * 1e6, 1), round(v.ideal_s * 1e6, 1), v.stretch
    chips, step_us, ideal_us, stretch = _both(run)
    assert chips == tuple(range(6, 18))
    assert (step_us, ideal_us) == (424.0, 429.2) and stretch < 1.0


def test_policy_primitives_and_registry():
    def run(m):
        p = m.policy
        free = {0, 1, 2, 8, 9, 10, 11, 16, 24, 25, 26, 27, 28, 29, 30, 31}
        geom = p.FabricGeometry(TILES)
        pod = p.FabricGeometry(TILES, chips_per_rack=16, span_racks=True)
        confined = p.FabricGeometry(TILES, chips_per_rack=16, span_racks=False)
        out = [p.pack_dense(sorted(free), 5, TILES), p.pack_tight(sorted(free), 3, TILES),
               p.place_packing(free, 6, geom), p.place_packing(free, 6, pod),
               p.place_packing(free, 12, confined), p.placement_candidates(free, 4, geom),
               p.placement_candidates(free, 4, pod), p.stranded_free(free, TILES),
               p.PLACEMENTS, p.WHATIF_BYTES, p.LOOKAHEAD_STEPS,
               _try(p.make_policy, "nope"), p.make_policy(None).name,
               p.FutureMorphObjective().compaction_targets((0, 1, 8), {2, 3}, TILES),
               p.MorphObjective().compaction_targets((0, 1), (2, 3), TILES)]
        pol = p.LocalityPolicy()
        out.append(_try(pol.whatif, set(range(16)), 4, geom))
        bound = p.PackingPolicy().bind(_rack_pricer(m), ALGOS)
        v = bound.whatif({0, 1, 2, 8, 9}, 5, geom)
        out.append((v.admitted, v.chips, v.step_s, v.ideal_s, v.stretch))
        out.append(_try(bound.whatif, {0, 1}, 0, geom))
        return out
    _both(run)


def test_pod_torus_and_sipac_allocators():
    def run(m):
        out = []
        pod = m.alloc.PodAllocator(64, chips_per_rack=32, tiles_per_server=TILES)
        for i, k in enumerate([20, 20, 10, 12, 2]):
            out.append(_try(pod.allocate, f"p{i}", k))
        confined = m.alloc.PodAllocator(64, chips_per_rack=32, span_racks=False)
        out += [_try(confined.allocate, "a", 20), _try(confined.allocate, "b", 20)]
        torus = m.alloc.make_allocator("torus", 64)
        out.append(torus.dims)
        for i, k in enumerate([8, 16, 6, 8, 27]):
            out.append(_try(torus.allocate, f"t{i}", k))
        sipac = m.alloc.make_allocator("sipac", 64, r=2, ell=3)
        for i, k in enumerate([8, 4, 3, 8, 2, 1]):
            out.append(_try(sipac.allocate, f"s{i}", k))
        lum = m.alloc.make_allocator("lumorph", 32)
        out += [_try(lum.allocate, "x", 10), _try(lum.allocate, "y", 30),
                _try(lum.allocate, "z", 0), _try(lum.release, "nobody"),
                _try(lum.reassign, "x", [0, 1, 2]), _try(lum.reassign, "x", [20, 20]),
                lum.fail_chips([1, 25]), sorted(lum.free), lum.live_chips, lum.utilization,
                _try(m.alloc.make_allocator, "mesh", 8), m.alloc._default_dims(96)]
        return out
    _both(run)


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("failed", [[0, 3], [0, 1, 2, 3, 4, 5, 6, 7], [63], [0, 9]])
def test_elastic_job_recovery(failed):
    def run(m):
        alloc = m.alloc.LumorphAllocator(16, tiles_per_server=TILES)
        job = m.ft.ElasticJob(alloc, "job", 8)
        other = alloc.allocate("other", 6)
        out = [job.chips, other.chips]
        for step, dead in ((20, failed), (40, [job.chips[-1]])):
            rec = job.on_failure(step, [c for c in dead])
            out.append(_plain((rec.step, rec.failed, rec.old_slice, rec.new_slice, rec.new_dp,
                               rec.recovered, rec.reason)))
            out.append((job.chips, job.dp_width, sorted(alloc.free)))
        return out
    _both(run)


def test_recovery_cost_stragglers_and_failures():
    def run(m):
        out = [m.ft.recovery_cost_model(n_params=340e6, dp=dp) for dp in (1, 2, 6, 8, 16)]
        out.append(m.ft.recovery_cost_model(n_params=1e9, dp=4, link=m.cm.IDEAL_SWITCH,
                                            ckpt_read_bw=5e9))
        out += [m.ft.largest_pow2_leq(n) for n in (0, 1, 2, 3, 7, 8, 100)]
        pol = m.ft.StragglerPolicy()
        times = np.array([1.0, 1.1, 0.9, 3.5, 1.0, 2.05])
        out += [pol.detect(times), pol.mitigated_step_time(times),
                pol.mitigated_step_time(np.ones(4)),
                [pol.mitigated_derate(f) for f in (0.5, 1.0, 2.0, 7.0)]]
        out.append([(e.step, e.chips) for e in m.ft.simulate_failures(50, 32, 40.0, seed=3)])
        alloc = m.alloc.LumorphAllocator(8)
        alloc.allocate("a", 6)
        r = m.ft.reallocate_after_failure(alloc, "b", 4)
        out.append(None if r is None else r.chips)
        return out
    _both(run)


def test_elastic_job_bypass_matches():
    """``allow_bypass=True`` swaps a free chip in at full width, as JAX's does;
    without a spare the bypass keeps the survivors."""
    def run(m):
        alloc = m.alloc.LumorphAllocator(16, tiles_per_server=TILES)
        job = m.ft.ElasticJob(alloc, "job", 8)
        out = []
        for step, dead in ((1, [job.chips[0]]), (2, job.chips[1:3])):
            rec = job.on_failure(step, list(dead), allow_bypass=True)
            out.append((rec, job.chips, job.dp_width, sorted(alloc.free)))
        alloc.allocate("rest", len(alloc.free))
        rec = job.on_failure(3, [job.chips[0]], allow_bypass=True)
        out.append((rec, job.chips, job.dp_width, sorted(alloc.free)))
        return out
    got = _both(run)
    assert [r[0][1]["reason"] for r in got] == ["bypassed"] * 3
    assert len(got[1][1]) == 8 and len(got[2][1]) == 7
