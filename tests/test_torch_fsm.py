"""The port's frequent-subgraph mining (gardenia_tpu_torch.mining.{fsm,
fsm_agg,gspan,dfscode,labels}) against the JAX package on the same
numpy-seeded graphs, on the CPU, exactly: the k <= 2 label aggregate and
gSpan at k = 1..5 beside both packages' engines and the brute-force
miner, over the label alphabets and supports of tests/test_mining.py,
the default degree labels and an R-MAT-9 graph; the lane pairs in
several chunks; the DFS-code copy and the NLF index against the JAX
package's."""

import itertools

import numpy as np
import pytest

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.mining import dfscode as jdfs
from gardenia_tpu.mining import fsm as jfsm
from gardenia_tpu.mining import fsm_agg as jagg
from gardenia_tpu.mining import gspan as jgspan
from gardenia_tpu.mining import labels as jlabels

from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.mining import dfscode, fsm, fsm_agg, gspan, labels


@pytest.mark.parametrize("k", (1, 2))
@pytest.mark.parametrize("seed,nlabels,minsup",
                         [(1, 2, 2), (2, 3, 3), (3, 4, 5), (4, 1, 2),
                          (5, 3, 8)])
def test_k2_aggregate_equals_jax_gspan_and_bruteforce(seed, nlabels, minsup,
                                                      k):
    g = random_graph(m=40, avg_deg=5, seed=seed, symmetric=True)
    lab = np.random.default_rng(seed).integers(0, nlabels, g.m)
    pg = from_csr_of(g)
    got = fsm_agg.fsm_k2_aggregate(pg, k, minsup, lab, device="cpu")
    assert got == jagg.fsm_k2_aggregate(g, k, minsup, lab)
    assert got == gspan.fsm_gspan(pg, k, minsup, lab, device="cpu")
    assert got == jgspan.fsm_gspan(g, k, minsup, lab)
    assert got == fsm.fsm_verifier(pg, k, minsup, lab) > 0
    assert got == fsm.fsm_solver(pg, k, minsup, lab, device="cpu")


@pytest.mark.parametrize("minsup", (2, 10, 40))
def test_k2_aggregate_default_labels(minsup):
    """The degree-bucket labels (the bench's and the CLI's)."""
    g = random_graph(m=60, avg_deg=6, seed=23, symmetric=True)
    pg = from_csr_of(g)
    got = fsm_agg.fsm_k2_aggregate(pg, 2, minsup, device="cpu")
    assert got == jagg.fsm_k2_aggregate(g, 2, minsup)
    assert got == gspan.fsm_gspan(pg, 2, minsup, device="cpu")


@pytest.fixture(scope="module")
def rmat9():
    return generate_graph("rmat", scale=9, degree=8, symmetrize=True,
                          need_reverse=False)


@pytest.mark.parametrize("minsup", (2, 30, 100))
def test_k2_aggregate_rmat_skew(minsup, rmat9):
    pg = from_csr_of(rmat9)
    got = fsm_agg.fsm_k2_aggregate(pg, 2, minsup, device="cpu")
    assert got == jagg.fsm_k2_aggregate(rmat9, 2, minsup) > 0
    assert got == gspan.fsm_gspan(pg, 2, minsup, device="cpu")


@pytest.mark.parametrize("nlabels,max_lanes", ((25, None), (5, 7)))
def test_k2_aggregate_lanes_in_several_chunks(monkeypatch, nlabels,
                                              max_lanes):
    """L = 25 (625 lane pairs, two chunks of MAX_LANES = 512), and
    MAX_LANES = 7 (four chunks of L * L = 25)."""
    if max_lanes:
        monkeypatch.setattr(fsm_agg, "MAX_LANES", max_lanes)
    g = random_graph(m=100, avg_deg=6, seed=nlabels, symmetric=True)
    lab = np.random.default_rng(nlabels).integers(0, nlabels, g.m)
    pg = from_csr_of(g)
    L = fsm_agg.label_ids(pg, lab)[1]
    assert L == nlabels and len(fsm_agg.lane_chunks(L)) > 1
    for k, minsup in ((2, 1), (2, 2), (1, 2)):
        got = fsm_agg.fsm_k2_aggregate(pg, k, minsup, lab, device="cpu")
        assert got == jagg.fsm_k2_aggregate(g, k, minsup, lab) > 0
        assert got == fsm.fsm_verifier(pg, k, minsup, lab)


@pytest.mark.parametrize("k,minsup", [(3, 2), (3, 4)])
def test_fsm_k3_equals_jax_and_bruteforce(k, minsup):
    g = random_graph(m=30, avg_deg=4, seed=7, symmetric=True)
    lab = np.random.default_rng(7).integers(0, 3, g.m)
    pg = from_csr_of(g)
    got = fsm.fsm_solver(pg, k, minsup, lab, device="cpu")
    assert got == jfsm.fsm_solver(g, k, minsup, lab)
    assert got == fsm.fsm_verifier(pg, k, minsup, lab) > 0
    assert got == gspan.fsm_gspan(pg, k, minsup, lab, chunk=5, device="cpu")


@pytest.mark.parametrize("k,minsup", [(4, 2), (4, 3), (5, 3)])
def test_fsm_k4plus_equals_jax_and_bruteforce(k, minsup):
    g = random_graph(m=16, avg_deg=3, seed=11, symmetric=True)
    lab = np.random.default_rng(3).integers(0, 2, g.m)
    pg = from_csr_of(g)
    got = fsm.fsm_solver(pg, k, minsup, lab, device="cpu")
    assert got == jfsm.fsm_solver(g, k, minsup, lab)
    assert got == fsm.fsm_verifier(pg, k, minsup, lab) > 0


def test_fsm_edge_cases(monkeypatch):
    g = random_graph(m=30, avg_deg=4, seed=7, symmetric=True)
    pg = from_csr_of(g)
    empty = from_csr_of(generate_graph("rmat", scale=4, degree=0,
                                       symmetrize=True))
    assert empty.nnz == 0
    for k in (0, 1, 2, 3):
        assert fsm.fsm_solver(empty, k, 1, device="cpu") == 0
    assert fsm.fsm_solver(pg, 0, 1, device="cpu") == 0
    with pytest.raises(ValueError, match="k <= 2"):
        fsm_agg.fsm_k2_aggregate(pg, 3, 2, device="cpu")
    monkeypatch.setattr(gspan, "MAX_EMBEDDINGS", 10)
    with pytest.raises(MemoryError, match="embedding frontier"):
        gspan.fsm_gspan(pg, 3, 1, device="cpu")


def random_patterns(n: int, seed: int):
    """Random connected labelled patterns of 2..5 vertices: a random tree
    plus a few random chords, labels 0..2."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        nv = int(rng.integers(2, 6))
        edges = {(int(rng.integers(0, v)), v) for v in range(1, nv)}
        for _ in range(int(rng.integers(0, 3))):
            a, b = sorted(rng.choice(nv, 2, replace=False).tolist())
            edges.add((a, b))
        yield nv, sorted(edges), rng.integers(0, 3, nv).tolist()


def test_dfscode_equals_jax():
    for nv, edges, labs in random_patterns(300, 5):
        pat = dfscode.make_pattern(nv, edges, labs)
        assert pat == jdfs.make_pattern(nv, edges, labs)
        code, perm = dfscode.canonical(pat)
        assert (code, perm) == jdfs.canonical(pat)
        assert dfscode.automorphisms(pat) == jdfs.automorphisms(pat)
        assert dfscode.extensions(pat) == jdfs.extensions(pat)
        assert dfscode.apply_perm(pat, perm) == jdfs.apply_perm(pat, perm)
        # the canonical form does not depend on the vertex order
        for p in itertools.islice(itertools.permutations(range(nv)), 6):
            assert dfscode.canonical(dfscode.apply_perm(pat, p))[0] == code
    assert dfscode.canonical((3, (), (2, 0, 1))) == \
        jdfs.canonical((3, (), (2, 0, 1)))


def test_mni_support_and_reorder_equal_jax():
    M = np.random.default_rng(2).integers(0, 9, (3, 40)).astype(np.int32)
    for nv, edges, labs in random_patterns(40, 9):
        if nv != 3:
            continue
        pat = dfscode.make_pattern(nv, edges, labs)
        assert gspan.mni_support(pat, M) == jgspan.mni_support(pat, M)
        perm = dfscode.canonical(pat)[1]
        np.testing.assert_array_equal(gspan._reorder(M, perm),
                                      jgspan._reorder(M, perm))


def test_nlf_index_and_filter_equal_jax():
    g = random_graph(m=60, avg_deg=5, seed=1, symmetric=True)
    L = 4
    lab = np.random.default_rng(0).integers(0, L, g.m)
    nlf = labels.nlf_index(from_csr_of(g), lab, L, device="cpu")
    want = np.asarray(jlabels.nlf_index(g, lab, L))
    np.testing.assert_array_equal(nlf.numpy(), want)
    for q in (5, 17, 40):
        np.testing.assert_array_equal(
            labels.nlf_filter(nlf, want[q]).numpy(),
            np.asarray(jlabels.nlf_filter(want, want[q])))
    np.testing.assert_array_equal(labels.label_frequency(lab, L),
                                  jlabels.label_frequency(lab, L))
