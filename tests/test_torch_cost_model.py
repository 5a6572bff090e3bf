"""The port's α–β cost model and schedule pricing against the JAX package's.

Both packages price in plain Python floats, so every price must come out
bit for bit (``==``), under the four named links:

  * ``algorithm_cost`` for every algorithm of ``ALGORITHMS`` (the IR-priced
    ones through ``Schedule.cost``, ``dnc`` in closed form), every closed
    form, and ``select_algorithm``, over p ∈ {2, 3, 4, 5, 8, 12, 16, 32, 64}
    and sizes from 1 B to 1 GB;
  * ``chunked_wave_costs``, ``chunked_algorithm_cost`` and
    ``overlapped_step_time`` with C ∈ {1, 2, 4, 8};
  * ``Schedule.cost``, ``reconfigurations`` and ``cost_by_tier``, and
    ``ChunkedSchedule.wave_costs``, ``chunk_costs``, ``cost`` and
    ``overlapped_cost`` of every builder;
  * what ``--comm auto`` picks for bert-large's 25 MB buckets.

The JAX modules compared here (``repro.core.cost_model`` and
``repro.core.scheduler``) import no JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as jcm  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro_torch.core import collectives as tcol  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402

LINKS = ("IDEAL_SWITCH", "LUMORPH_LINK", "TPU_LINK", "POD_RAIL_LINK")
PS = (2, 3, 4, 5, 8, 12, 16, 32, 64)
SIZES = sorted({1.0, 100.0, 1e9, 25 * 2 ** 20, 25 * 2 ** 20 / 3}
               | {float(x) for x in np.logspace(0, 9, 28)})
CHUNKS = (1, 2, 4, 8)


def _links(name):
    return getattr(jcm, name), getattr(tcm, name)


def test_constants_and_links_are_the_references():
    for name in ("PAPER_LINK_BW", "PAPER_ALPHA", "MZI_RECONFIG_DELAY", "TPU_ICI_BW",
                 "TPU_ALPHA", "POD_RAIL_BW", "POD_RAIL_ALPHA", "RAIL_RECONFIG_DELAY",
                 "BER_DERATE", "LASER_DRIFT_DERATE", "IR_COST_CACHE_SIZE", "IR_PRICED"):
        assert getattr(tcm, name) == getattr(jcm, name), name
    for name in LINKS:
        j, t = _links(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert t.beta == j.beta and t.round_alpha(True) == j.round_alpha(True)
    assert sorted(tcm.ALGORITHMS) == sorted(jcm.ALGORITHMS)


@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("p", PS)
def test_algorithm_cost_and_selection_bit_for_bit(link, p):
    jl, tl = _links(link)
    for n in SIZES:
        for algo in jcm.ALGORITHMS:
            assert tcm.algorithm_cost(algo, n, p, tl) == jcm.algorithm_cost(algo, n, p, jl), \
                (algo, n)
            if algo == "lumorph2" and p & (p - 1):
                with pytest.raises(ValueError, match="p=2"):
                    tcm.rhd_all_reduce_cost(n, p, tl)
                continue
            assert tcm.ALGORITHMS[algo](n, p, tl) == jcm.ALGORITHMS[algo](n, p, jl), (algo, n)
        assert tcm.select_algorithm(n, p, tl) == jcm.select_algorithm(n, p, jl), n
        every = tuple(jcm.ALGORITHMS)
        assert tcm.select_algorithm(n, p, tl, every) == jcm.select_algorithm(n, p, jl, every)
    assert tcm.all_reduce_curve(p, tl, SIZES[:6]) == jcm.all_reduce_curve(p, jl, SIZES[:6])


@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("p", PS)
def test_chunked_prices_bit_for_bit(link, p):
    jl, tl = _links(link)
    for n in SIZES[::3]:
        for algo in jcm.IR_PRICED:
            for c in CHUNKS:
                assert tcm.chunked_wave_costs(algo, n, p, tl, c) == \
                    jcm.chunked_wave_costs(algo, n, p, jl, c), (algo, n, c)
                assert tcm.chunked_algorithm_cost(algo, n, p, tl, c) == \
                    jcm.chunked_algorithm_cost(algo, n, p, jl, c), (algo, n, c)
                for compute in (0.0, 3e-5, 2e-3):
                    assert tcm.overlapped_step_time(algo, n, p, tl, c, compute) == \
                        jcm.overlapped_step_time(algo, n, p, jl, c, compute), (algo, n, c)
    with pytest.raises(ValueError, match="no chunked lowering"):
        tcm.chunked_algorithm_cost("dnc", 1e6, p, tl, 2)


@pytest.mark.parametrize("algo", ["ring", "lumorph2", "lumorph4", "tree"])
@pytest.mark.parametrize("p", [2, 3, 4, 8, 12, 16])
def test_schedule_and_chunked_schedule_pricing(algo, p):
    link_j, link_t = jcm.LUMORPH_LINK, tcm.LUMORPH_LINK
    n = 25 * 2 ** 20
    js, ts = jsch.build_schedule(algo, range(p), n), tsch.build_schedule(algo, range(p), n)
    assert ts.cost(link_t) == js.cost(link_j)
    assert ts.reconfigurations() == js.reconfigurations()
    assert [r.circuit_signature for r in ts.rounds] == [r.circuit_signature for r in js.rounds]
    by_tier = ts.cost_by_tier(link_t)
    assert by_tier == js.cost_by_tier(link_j) and list(by_tier) == [0]
    # ``cost`` is Python's ``sum``, compensated since 3.12; ``cost_by_tier``
    # adds in a loop, in both packages: the two agree to a few ulps
    assert sum(by_tier.values()) == pytest.approx(ts.cost(link_t), rel=1e-14)
    assert not ts.materialized  # pricing builds no Transfer tables
    for c in CHUNKS:
        jc, tc = jsch.chunk_schedule(js, c), tsch.chunk_schedule(ts, c)
        assert tc.algo == jc.algo
        assert tc.wave_costs(link_t) == jc.wave_costs(link_j)
        assert tc.chunk_costs(link_t) == jc.chunk_costs(link_j)
        assert tc.cost(link_t) == jc.cost(link_j)
        assert tc.overlapped_cost(link_t, compute_s=1e-3) == \
            jc.overlapped_cost(link_j, compute_s=1e-3)
        assert sum(tc.wave_costs(link_t)) == pytest.approx(tc.cost(link_t), rel=1e-14)
    assert not ts.materialized


def test_fabric_pricing_and_validation_are_refused():
    """The port prices on the ideal fabric only: the rack and pod models are
    the JAX package's simulator's."""
    sched = tsch.build_schedule("ring", range(4), 1e6)
    with pytest.raises(NotImplementedError, match="rack=None"):
        sched.cost(tcm.LUMORPH_LINK, rack=object())
    with pytest.raises(NotImplementedError, match="rack=None"):
        tsch.chunk_schedule(sched, 2).validate(object())


def test_auto_picks_lumorph4_for_bert_large_buckets_at_four_ranks():
    """bert-large's 333,344,768 fp32 gradient elements in 25 MB buckets: at
    p = 4 every bucket (and the tail) is cheapest as LUMORPH-4, at p = 2 and
    8 as Ring, in both packages."""
    from repro_torch.optim.grad_comm import make_buckets
    buckets = make_buckets(333_344_768)
    assert len(buckets) == 51
    for p, want in ((4, "lumorph4"), (2, "ring"), (8, "ring")):
        for b in buckets:
            n = b.n_elems * 4
            assert tcm.select_algorithm(n, p, tcm.LUMORPH_LINK) == want, (p, n)
            assert jcm.select_algorithm(n, p, jcm.LUMORPH_LINK) == want, (p, n)


def test_clear_pricing_caches_clears_the_ports_caches():
    tcm.algorithm_cost("ring", 1e6, 4, tcm.LUMORPH_LINK)
    tcm.chunked_algorithm_cost("ring", 1e6, 4, tcm.LUMORPH_LINK, 2)
    tcol.all_reduce(torch.ones(4, 8), "ring")
    tcol.overlapped_all_reduce(torch.ones(4, 8), "ring", n_chunks=2)
    caches = (tcm._ir_cost, tcm._chunked_wave_costs, tcol.schedule_for_execution,
              tcol._compiled, tcol._wave_program)
    assert all(f.cache_info().currsize > 0 for f in caches)
    tcm.clear_pricing_caches()
    assert [f.cache_info().currsize for f in caches] == [0] * len(caches)
