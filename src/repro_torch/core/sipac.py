"""SiPAC(r, ℓ) topology emulation on LUMORPH (paper Fig 3).

The port's copy of ``repro.core.sipac``, line for line; it keeps the
reference's ``networkx`` isomorphism check.

SiPAC(r, ℓ) is the BCube-derived photonic topology of Wu et al. (JOCN'24):
r^ℓ GPUs, each with ℓ interfaces; GPUs whose ℓ-digit base-r addresses agree
in all but one digit are fully connected within that digit group.  As a
graph this is the Hamming graph H(ℓ, r) with each dimension's r-clique.

The paper's Fig 3 claim: LUMORPH can configure its MZI circuits to realize
SiPAC(r, ℓ) for *any* r and ℓ, so tenants keep the optimal Flex-SiPCO
ALLREDUCE.  We verify by (1) building the SiPAC edge set, (2) asking the
rack to validate a round that lights every SiPAC edge simultaneously, and
(3) checking graph isomorphism against the circuit configuration.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import networkx as nx

from repro_torch.core.cost_model import LinkModel, rqq_all_reduce_cost
from repro_torch.core.fabric import LumorphRack


def sipac_edges(r: int, ell: int) -> list[tuple[int, int]]:
    """Undirected edge list of SiPAC(r, ℓ) over nodes 0..r^ℓ−1."""
    edges = []
    n = r ** ell
    for a, b in itertools.combinations(range(n), 2):
        da, db = _digits(a, r, ell), _digits(b, r, ell)
        if sum(x != y for x, y in zip(da, db)) == 1:
            edges.append((a, b))
    return edges


def _digits(x: int, r: int, ell: int) -> tuple[int, ...]:
    out = []
    for _ in range(ell):
        out.append(x % r)
        x //= r
    return tuple(out)


def sipac_graph(r: int, ell: int) -> nx.Graph:
    g = nx.Graph()
    g.add_nodes_from(range(r ** ell))
    g.add_edges_from(sipac_edges(r, ell))
    return g


def configure_sipac_on_lumorph(rack: LumorphRack, chips: Sequence[int],
                               r: int, ell: int) -> list[tuple[int, int]]:
    """Program the rack so ``chips`` (len r^ℓ) form a SiPAC(r, ℓ).

    Returns the directed circuit pairs; raises CircuitError if the photonic
    resources (TRX banks / wavelengths / fibers) cannot host the topology.
    Each undirected SiPAC edge needs a circuit in both directions.
    """
    n = r ** ell
    if len(chips) != n:
        raise ValueError(f"need {n} chips for SiPAC({r},{ell}), got {len(chips)}")
    pairs: list[tuple[int, int]] = []
    for a, b in sipac_edges(r, ell):
        pairs.append((chips[a], chips[b]))
        pairs.append((chips[b], chips[a]))
    rack.validate_round(pairs)  # degree/wavelength/fiber feasibility
    rack.reconfigure(pairs)  # one MZI reprogramming window
    return pairs


def emulation_is_exact(rack: LumorphRack, chips: Sequence[int], r: int, ell: int) -> bool:
    """Fig 3 check: the live circuit graph ≅ SiPAC(r, ℓ)."""
    live = nx.Graph()
    live.add_nodes_from(chips)
    for c in rack.live_circuits():
        live.add_edge(c.src, c.dst)
    return nx.is_isomorphic(live, sipac_graph(r, ell))


def flex_sipco_cost(n_bytes: float, r: int, ell: int, link: LinkModel) -> float:
    """Flex-SiPCO ALLREDUCE on SiPAC(r, ℓ) = dimension-by-dimension radix-r
    reduce-scatter/all-gather — identical round structure to LUMORPH's
    mixed-radix quartering with radices [r]*ℓ (cost model §4)."""
    return rqq_all_reduce_cost(n_bytes, r ** ell, link, radix=r)
