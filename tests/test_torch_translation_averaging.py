"""The port's translation averaging (panovlm_tpu_torch/models/
translation_averaging.py) against the JAX package's on the same numpy
inputs: a seeded pose graph of 10 cameras, each paired with its next three
(sfm_graphs.translation_graph, the graph of
tests/test_sfm_core.py::_translation_graph), unit directions
with 1e-3 of noise, every fourth pair without a measured scale.

The DLT init is injected: both packages start chordal, lud, bata and l1
from the JAX function's DLT. The DLT's global scale is the near-null mode
of its damped normal equations (eigenvalue ~1e-6), which 200 float32 CG
steps do not resolve: on this graph the JAX DLT's scales sit 3.3 % from
those of the same CG in float64 and move by up to 0.9 % when one input
changes by one ulp, the port's 0.3 % from float64. Chordal is invariant
to that scale, and l1 and the unmeasured pairs keep it, so without the
injection the two packages differ by the DLT's rounding, not by the
method.

Tolerances, each stated at its assertion:
  * chordal, lud, bata and l1, and softl1 from the GPS init: translations
    and scales within 1e-3 of the JAX function's, the tolerance of
    tests/test_torch_sfm.py::test_translation_averaging_softl1_matches_jax
    (a few LM or CG iterations of float32 rounding apart);
  * the L-infinity LP: the same success flag and translations within 1e-6
    (both call scipy's HiGHS on the same float64 LP);
  * the lud and chordal residuals: within 1e-6 on random rows;
  * the triplet search: exactly networkx's triangles and order.
"""

import networkx as nx
import numpy as np
import pytest
import torch

from panovlm_tpu.models import translation_averaging as ta
from panovlm_tpu.solver import residuals as jres
from panovlm_tpu_torch.models import translation_averaging as tta
from panovlm_tpu_torch.solver import residuals as tres
from panovlm_tpu_torch.utils import graph as tgraph
from panovlm_tpu_torch.utils.gps import init_translation_gps

from sfm_graphs import translation_graph

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def graph():
    aa, C, pi, pj, rel_aa, u, scale = translation_graph()
    scales = scale.copy()
    scales[::4] = -1.0                       # pairs without a measured scale
    dlt = ta.translation_averaging_dlt(aa, pi, pj, rel_aa, u)
    return dict(aa=aa, C=C, args=(aa, pi, pj, rel_aa, u, scales), dlt=dlt)


@pytest.mark.parametrize("method", ["chordal", "lud", "bata", "l1"])
def test_methods_match_jax(graph, method, monkeypatch):
    monkeypatch.setattr(tta, "translation_averaging_dlt",
                        lambda *a, **k: tuple(x.copy() for x in graph["dlt"]))
    t_j, s_j = ta.translation_averaging(*graph["args"], method=method)
    t_t, s_t = tta.translation_averaging(*graph["args"], method=method)
    assert np.isfinite(t_t).all() and np.isfinite(s_t).all()
    assert np.abs(t_t - t_j).max() < 1e-3, np.abs(t_t - t_j).max()
    assert np.abs(s_t - s_j).max() < 1e-3, np.abs(s_t - s_j).max()


def test_softl1_from_the_gps_init_matches_jax(graph):
    rng = np.random.default_rng(5)
    gps = graph["C"] + rng.normal(size=graph["C"].shape) * 0.02
    t_init = init_translation_gps(gps, graph["aa"])
    t_j, s_j = ta.translation_averaging(*graph["args"], method="softl1", t_init=t_init)
    t_t, s_t = tta.translation_averaging(*graph["args"], method="softl1", t_init=t_init)
    assert np.abs(t_t - t_j).max() < 1e-3
    assert np.abs(s_t - s_j).max() < 1e-3


@pytest.mark.parametrize("case", ["graph", "chain", "masked"])
def test_linf_lp_matches_jax(graph, case):
    aa, pi, pj, rel_aa, u, _ = graph["args"]
    mask = np.ones(len(pi), bool)
    if case == "chain":                      # consecutive pairs only: no triangle
        mask = pj == pi + 1
    elif case == "masked":
        mask[::3] = False
    t_j, ok_j = ta.translation_averaging_linf_lp(aa, pi, pj, rel_aa, u, mask)
    t_t, ok_t = tta.translation_averaging_linf_lp(aa, pi, pj, rel_aa, u, mask)
    assert ok_t == ok_j
    if case == "chain":
        assert (t_t, ok_t) == (None, False)
    else:
        assert ok_t
        assert np.abs(t_t - t_j).max() < 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triplets_are_networkx_triangles(seed):
    """graph.common_neighbors and the LP's triplet list against networkx on
    a random graph with repeated and masked pairs, with the linspace cut."""
    rng = np.random.default_rng(seed)
    pi = rng.integers(0, 30, 400)
    pj = rng.integers(0, 30, 400)
    keep = pi != pj
    pi, pj = pi[keep], pj[keep]
    mask = rng.random(len(pi)) < 0.8
    g, tg = nx.Graph(), tgraph.Graph()
    for a, b, m in zip(pi, pj, mask):
        if m:
            g.add_edge(int(a), int(b))
            tg.add_edge(int(a), int(b))
    want = []
    for a, b in g.edges:
        assert tgraph.common_neighbors(tg, a, b) == set(nx.common_neighbors(g, a, b))
        for c in sorted(nx.common_neighbors(g, a, b)):
            if c > max(a, b):
                want.append(tuple(sorted((a, b, c))))
    for cap in (20000, 50):
        got, _, found = tta.linf_triplets(pi, pj, mask, cap)
        assert found == len(want) > 50
        sel = want if cap >= len(want) else [
            want[s] for s in np.linspace(0, len(want) - 1, cap).astype(int)]
        assert got == sel


@pytest.mark.parametrize("name", ["lud", "chordal"])
def test_residuals_match_jax(name):
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    c1, c2 = rng.normal(size=(2, 64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = rng.uniform(0.5, 2.0, (64, 1)).astype(np.float32)
    args = (c1, c2, s, d) if name == "lud" else (c1, c2, d)
    want = np.asarray(jax.vmap(getattr(jres, name))(*map(jnp.asarray, args)))
    got = torch.vmap(getattr(tres, name))(*map(torch.from_numpy, args)).numpy()
    assert np.abs(got - want).max() < 1e-6
