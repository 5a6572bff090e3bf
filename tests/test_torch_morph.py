"""The port's morph planner and failure bypass against the JAX package's,
exactly.

``core.scheduler.transfer_schedule``, the morph plans (compaction, bypass,
scale up, scale down) with their invariants, prices and commits,
``MorphPolicy``'s proposals, and the fault-tolerance runtime's bypass and
straggler paths are copies of plain-Python modules of the JAX package.
Every case runs the same allocator history through both packages in this
one process and compares plans, costs and post-commit allocations as plain
data (exceptions by type name and message). The states are built the way
``tests/test_morph.py`` builds them, at fixed sizes.

No case draws at random: every input is enumerated.
"""

import types

import numpy as np
import pytest

from repro import morph as jmorph  # noqa: E402
from repro.core import allocator as jalloc  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import fabric as jfab  # noqa: E402
from repro.core import rack as jrack  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro.morph import plan as jplan  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro_torch import morph as tmorph  # noqa: E402
from repro_torch.core import allocator as talloc  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import fabric as tfab  # noqa: E402
from repro_torch.core import rack as track  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402
from repro_torch.morph import plan as tplan  # noqa: E402
from repro_torch.runtime import fault_tolerance as tft  # noqa: E402

from test_torch_rack import _plain, _try  # noqa: E402

J = types.SimpleNamespace(morph=jmorph, plan=jplan, alloc=jalloc, cm=jcm, fab=jfab, rack=jrack,
                          sch=jsch, ft=jft)
T = types.SimpleNamespace(morph=tmorph, plan=tplan, alloc=talloc, cm=tcm, fab=tfab, rack=track,
                          sch=tsch, ft=tft)
TILES = 8
STATE = float(1 << 20)
ALGOS = ("ring", "lumorph2", "lumorph4")
#: allocator histories: (requests, indices of live tenants released in turn)
HISTORIES = [
    ([4, 4, 8, 6, 3, 12, 5], [0, 2]),
    ([16, 3, 5, 9, 2, 7, 1, 6], [1, 1, 3]),
    ([6, 6, 6, 6, 6, 6, 6, 6, 6, 6], [0, 4, 2]),
    ([12, 16, 1, 2, 3, 4, 5], [5]),
    ([8, 8, 8, 8, 8, 8, 8, 8], [7, 0, 3]),
    # histories whose departures leave tenants the policies compact
    ([8, 5, 5, 13, 5, 11, 7, 5, 5, 4], [0, 9]),
    ([15, 3, 14, 12, 6, 6, 4, 12], [7, 9]),
    ([3, 15, 11, 1, 6, 11, 12, 7, 5], [2, 9, 1, 6, 5]),
]


def _both(scenario):
    j, t = _plain(scenario(J)), _plain(scenario(T))
    assert t == j
    return t


def _rack(m, fibers: int = 2):
    return m.fab.LumorphRack(n_servers=8, tiles_per_server=TILES, fibers_per_server_pair=fibers)


def _fragmented(m, requests, releases):
    """Replay an alloc/release history, as tests/test_morph.py does; returns
    the allocator and the tenants still live."""
    a = m.alloc.LumorphAllocator(64, tiles_per_server=TILES)
    live = []
    for i, k in enumerate(requests):
        if k <= len(a.free):
            a.allocate(f"t{i}", k)
            live.append(f"t{i}")
    for idx in releases:
        if live:
            a.release(live.pop(idx % len(live)))
    return a, live


def _allocs(a):
    return ({t: x.chips for t, x in sorted(a.allocations.items())}, sorted(a.free))


def _plan(m, plan, rack):
    """A plan, its price on the ideal fabric and on ``rack``."""
    if plan is None:
        return None
    link = m.cm.LUMORPH_LINK
    return (plan, plan.n_moves, plan.cost(link), plan.cost(link, rack=rack),
            plan.schedule.reconfigurations(), plan.schedule.cost(link, rack=rack))


# ---------------------------------------------------------------------------
# transfer_schedule
# ---------------------------------------------------------------------------

def test_transfer_schedule():
    def run(m):
        rack = _rack(m)
        out = []
        for waves in ([[(0, 9)]], [[(0, 9), (1, 17)], [], [(9, 2), (17, 3), (4, 60)]],
                      [[(0, 1), (0, 2), (0, 3), (0, 4), (0, 5)]], [[(3, 3)]], []):
            s = _try(m.sch.transfer_schedule, waves, 1e6, tag="t")
            out.append(s)
            if s[0] == "ok":
                sched = m.sch.transfer_schedule(waves, 1e6)
                out += [sched.reconfigurations(), sched.cost(m.cm.LUMORPH_LINK),
                        sched.cost(m.cm.LUMORPH_LINK, rack=rack),
                        _try(sched.validate, rack), _try(sched.validate, rack, check_fibers=False)]
                sched.materialize()
                out.append([[(x.perm, x.reduce) for x in r.transfers] for r in sched.rounds])
        return out
    _both(run)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hist", range(len(HISTORIES)))
def test_compaction_plans_and_commits(hist):
    def run(m):
        a, live = _fragmented(m, *HISTORIES[hist])
        rack = _rack(m)
        out = []
        for t in live:
            chips = a.allocations[t].chips
            out.append(m.plan.pack_layout(chips, sorted(a.free), TILES))
            plan = m.morph.plan_compaction(t, chips, a.free, TILES, STATE, rack=rack)
            out.append(_plan(m, plan, rack))
            if plan is not None:
                out.append(_try(m.morph.apply_plan, a, plan, rack=rack))
                m.morph.check_conservation(a)
            out.append(_allocs(a))
        return out
    _both(run)


@pytest.mark.parametrize("n_dead", [1, 2, 5])
@pytest.mark.parametrize("hist", range(len(HISTORIES)))
def test_bypass_plans_and_commits(hist, n_dead):
    def run(m):
        a, live = _fragmented(m, HISTORIES[hist][0], [])
        rack = _rack(m)
        out = []
        for t in live[:3]:
            chips = a.allocations[t].chips
            dead = list(chips[:min(n_dead, len(chips))])
            plan = m.morph.plan_bypass(t, chips, dead, a.free, TILES, STATE, rack=rack)
            out.append(_plan(m, plan, rack))
            if plan is not None:
                report = _try(m.morph.execute, a, plan, m.cm.LUMORPH_LINK, rack=rack)
                out.append(report)
            out.append(_allocs(a))
        return out
    _both(run)


@pytest.mark.parametrize("hist", range(len(HISTORIES)))
def test_scale_up_and_down(hist):
    def run(m):
        a, live = _fragmented(m, *HISTORIES[hist])
        rack = _rack(m)
        out = []
        for t in live[:3]:
            chips = a.allocations[t].chips
            for n_new in (0, 1, 3, 8, 64):
                out.append(_plan(m, m.morph.plan_scale_up(t, chips, a.free, n_new, TILES, STATE,
                                                          rack=rack), rack))
            for keep in (chips[:1], chips[: len(chips) // 2], chips, chips[1:] + (999,)):
                out.append(_try(lambda: _plan(m, m.morph.plan_scale_down(
                    t, chips, keep, TILES, STATE, rack=rack), rack)))
            up = m.morph.plan_scale_up(t, chips, a.free, 2, TILES, STATE, rack=rack)
            if up is not None:
                out.append(_try(m.morph.apply_plan, a, up, rack=rack))
                chips = a.allocations[t].chips
                down = m.morph.plan_scale_down(t, chips, chips[:-1], TILES, STATE, rack=rack)
                out.append(_try(m.morph.apply_plan, a, down, rack=rack))
            out.append(_allocs(a))
        return out
    _both(run)


def test_pod_plans():
    def run(m):
        pod = m.rack.Pod(n_racks=2, chips_per_rack=32, tiles_per_server=TILES,
                         fibers_per_server_pair=2)
        chips = (0, 1, 2, 3, 32, 33, 34, 35)
        free = [4, 5, 6, 7, 8, 9, 40, 41, 42]
        return [
            m.plan.pack_layout(chips, free, TILES, chips_per_rack=32),
            _plan(m, m.morph.plan_compaction("t", chips, free, TILES, STATE, rack=pod,
                                             chips_per_rack=32), pod),
            _plan(m, m.morph.plan_bypass("t", chips, [0, 33], free, TILES, STATE, rack=pod,
                                         chips_per_rack=32), pod),
            _plan(m, m.morph.plan_scale_up("t", chips, free, 4, TILES, STATE, rack=pod,
                                           chips_per_rack=32), pod),
            _plan(m, m.morph.plan_scale_down("t", chips, (0, 1, 32, 33), TILES, STATE,
                                             rack=pod, chips_per_rack=32), pod),
        ]
    _both(run)


def test_plan_invariant_errors():
    def run(m):
        P = m.plan
        sched = m.sch.transfer_schedule([], 1e6)
        moved = m.sch.transfer_schedule([[(0, 2), (2, 3)]], 1e6)
        cases = [
            (P.COMPACTION, (0, 1), (0, 2), (), sched),
            (P.COMPACTION, (0, 1), (0, 2, 3), ((1, 2),), sched),
            (P.COMPACTION, (0, 0), (0, 2), ((0, 2),), sched),
            (P.BYPASS, (0, 1), (0, 1, 2), ((0, 2),), sched),
            (P.BYPASS, (0, 1), (0, 5), ((7, 5),), sched),
            (P.SCALE_UP, (0, 1), (0, 2), ((0, 2),), sched),
            (P.SCALE_DOWN, (0, 1), (0, 1), (), sched),
            (P.SCALE_DOWN, (0, 1, 2), (0,), ((0, 1),), sched),
            (P.COMPACTION, (0, 1), (0, 2), ((1, 2),), moved),
        ]
        rack = _rack(m)
        return [_try(P.MorphPlan(tenant="t", kind=k, old_chips=o, new_chips=n, moves=mv,
                                 state_bytes=1e6, schedule=s).validate, rack)
                for k, o, n, mv, s in cases]
    _both(run)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

def _policies(m, rack):
    cfg = m.morph.MorphConfig()
    return {
        "default": m.morph.MorphPolicy(cfg, rack=rack, link=m.cm.LUMORPH_LINK, algos=ALGOS,
                                       tiles_per_server=TILES),
        "no_amortize": m.morph.MorphPolicy(
            m.morph.MorphConfig(amortize=False, state_bytes=4e6), rack=rack,
            link=m.cm.LUMORPH_LINK, algos=ALGOS, tiles_per_server=TILES),
        "locality": m.morph.MorphPolicy(cfg, rack=rack, link=m.cm.LUMORPH_LINK, algos=ALGOS,
                                        tiles_per_server=TILES,
                                        objective=m.morph.LocalityObjective()),
        "future": m.morph.MorphPolicy(cfg, rack=rack, link=m.cm.LUMORPH_LINK, algos=ALGOS,
                                      tiles_per_server=TILES,
                                      objective=m.morph.FutureMorphObjective()),
    }


@pytest.mark.parametrize("hist", range(len(HISTORIES)))
def test_morph_policy_proposals(hist):
    def run(m):
        a, live = _fragmented(m, *HISTORIES[hist])
        rack = _rack(m)
        out = []
        for name, pol in _policies(m, rack).items():
            for t in live:
                chips = a.allocations[t].chips
                k = len(chips)
                out.append((name, t, pol.step_cost(chips, k, STATE)))
                for steps in (0, 10, 1000):
                    out.append(_try(pol.propose_compaction, t, chips, k, STATE,
                                    remaining_steps=steps, free=sorted(a.free)))
                out.append(_try(pol.propose_bypass, t, chips, k, STATE, chips[:2], sorted(a.free)))
                out.append(_try(pol.propose_scale_up, t, chips, 2, STATE, sorted(a.free)))
                out.append(_try(pol.propose_scale_down, t, chips, chips[: max(1, k // 2)],
                                STATE, whatif_bytes=4e6))
        return out
    _both(run)


def test_compaction_across_the_seam():
    """examples/morph_rack.py's act 1: two half-server tenants force a third
    across the servers' seam; a departure lets every policy pull it back."""
    def run(m):
        rack = m.fab.LumorphRack(n_servers=2, tiles_per_server=TILES, fibers_per_server_pair=1)
        out = []
        for name, pol in _policies(m, rack).items():
            alloc = m.alloc.LumorphAllocator(16, tiles_per_server=TILES)
            alloc.allocate("a", 4)
            alloc.allocate("b", 4)
            frag = alloc.allocate("frag", 8)
            alloc.release("a")
            pm = pol.propose_compaction("frag", frag.chips, 8, float(4 << 20),
                                        remaining_steps=500, free=sorted(alloc.free))
            report = None if pm is None else m.morph.execute(alloc, pm.plan, m.cm.LUMORPH_LINK,
                                                             rack=rack)
            out.append((name, pm, report))
        return out
    assert all(pm is not None for _, pm, _ in _both(run))


def test_scale_down_refused_on_a_rail_inadmissible_keep_set():
    """tests/test_morph.py's pod regression, in both packages."""
    def run(m):
        pod = m.rack.Pod(n_racks=2, chips_per_rack=8, tiles_per_server=4)
        pol = m.morph.MorphPolicy(m.morph.MorphConfig(), rack=pod, link=m.cm.LUMORPH_LINK,
                                  algos=("hier:lumorph2",), tiles_per_server=4,
                                  chips_per_rack=8)
        chips = (0, 1, 2, 3, 8, 9, 10, 11)
        return (pol.propose_scale_down("t", chips, keep=(0, 1, 8, 9), drain_bytes=STATE),
                pol.propose_scale_down("t", chips, keep=(0, 1, 2, 3, 8, 9), drain_bytes=STATE))
    ok, bad = _both(run)
    assert ok is not None and bad is None


# ---------------------------------------------------------------------------
# fault tolerance: the bypass and the straggler -> degrade path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    (64, 16, 48, 2, "bypassed"), (64, 12, 48, 5, "bypassed"), (64, 12, 52, 2, "bypassed"),
    (16, 8, 8, 1, "bypassed"), (64, 16, 0, 16, "full")])
def test_elastic_job_bypass(case):
    """``on_failure(allow_bypass=True)``: JAX's records; a slice with a
    surviving peer is bypassed, one that lost every chip restarts."""
    n_chips, width, filler, n_dead, reason = case

    def run(m):
        alloc = m.alloc.LumorphAllocator(n_chips, tiles_per_server=TILES)
        job = m.ft.ElasticJob(alloc, "train", width)
        if filler:
            alloc.allocate("filler", min(filler, len(alloc.free)))
        out = [job.chips]
        for step, dead in ((10, job.chips[:n_dead]), (20, job.chips[-1:])):
            rec = job.on_failure(step=step, failed_chips=list(dead), allow_bypass=True)
            out.append((rec, job.chips, job.dp_width, _allocs(alloc)))
        return out
    assert _both(run)[1][0][1]["reason"] == reason


def test_bypass_failure_directly():
    def run(m):
        out = []
        for tiles in (None, 4):
            alloc = m.alloc.LumorphAllocator(32, tiles_per_server=TILES)
            a = alloc.allocate("v", 12)
            alloc.allocate("w", 16)
            out.append(_try(m.ft.bypass_failure, alloc, "v", a.chips[:3], tiles_per_server=tiles))
            out.append(_allocs(alloc))
            out.append(_try(m.ft.bypass_failure, alloc, "nobody", [0]))
        return out
    _both(run)


@pytest.mark.parametrize("times", [
    [1.0, 1.1, 0.9, 3.5, 1.0, 2.05], [1.0] * 8, [0.0, 0.0, 0.0], [1.0, 9.0, 1.0, 1.0],
    [2.0, 2.0, 2.0, 7.0, 2.1, 2.2, 4.5, 2.0]])
def test_straggler_to_degrade(times):
    def run(m):
        chips = list(range(40, 40 + len(times)))
        out = [m.ft.straggler_to_degrade(5.0, chips, np.asarray(times))]
        pol = m.ft.StragglerPolicy(straggler_factor=1.2, spare_wavelengths=1)
        out.append(m.ft.straggler_to_degrade(7.5, chips, times, policy=pol))
        return out
    _both(run)
