"""The plain reference against scipy and numpy on small graphs."""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import shortest_path

from graphbench import generators, reference

KRON = {"generator": "kron", "scale": 9, "edge_factor": 16,
        "a": 0.57, "b": 0.19, "c": 0.19}
URAND = {"generator": "urand", "scale": 9, "edge_factor": 4}


def _pair(cfg, seed):
    e = generators.generate(cfg, seed, "cpu")
    m, src, dst = e.m, e.src, e.dst
    g = reference.clean_csr(m, src, dst, symmetrize=True)
    s, d = src.numpy().astype(np.int64), dst.numpy().astype(np.int64)
    a = sp.coo_matrix((np.ones(2 * len(s)), (np.r_[s, d], np.r_[d, s])),
                      shape=(m, m)).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    a.data[:] = 1.0
    a.sort_indices()
    return g, a


@pytest.mark.parametrize("cfg", [KRON, URAND], ids=["kron", "urand"])
def test_csr_matches_scipy(cfg):
    g, a = _pair(cfg, 11)
    assert np.array_equal(g.rowptr.numpy(), a.indptr)
    assert np.array_equal(g.cols.numpy(), a.indices)
    assert g.stats()["dag_edges"] * 2 == a.nnz


@pytest.mark.parametrize("cfg", [KRON, URAND], ids=["kron", "urand"])
def test_pagerank_matches_scipy_power_iteration(cfg):
    g, a = _pair(cfg, 12)
    m = a.shape[0]
    deg = np.asarray(a.sum(axis=1)).ravel()
    x = np.full(m, 1.0 / m)
    errs = []
    for _ in range(100):
        contrib = np.where(deg > 0, x / np.maximum(deg, 1), 0.0)
        new = (1 - 0.85) / m + 0.85 * (a.T @ contrib)
        errs.append(np.abs(new - x).sum())
        x = new
        if errs[-1] < 1e-4:
            break
    kept, ref_errs, stop = reference.pagerank(g, 1e-4, keep={len(errs)})
    assert stop == len(errs)
    np.testing.assert_allclose(ref_errs, errs, rtol=1e-9)
    np.testing.assert_allclose(kept[stop].numpy(), x, rtol=1e-12)


@pytest.mark.parametrize("cfg", [KRON, URAND], ids=["kron", "urand"])
def test_bfs_matches_scipy(cfg):
    g, a = _pair(cfg, 13)
    for source in (0, 7, int(np.argmax(np.diff(a.indptr)))):
        want = shortest_path(a, unweighted=True, indices=source)
        want = np.where(np.isinf(want), -1, want).astype(np.int64)
        assert np.array_equal(reference.bfs(g, source).numpy(), want)
        cut = reference.bfs(g, source, drop_last_level=True).numpy()
        assert (cut == want.max()).sum() == 0
        assert np.array_equal(cut[want < want.max()], want[want < want.max()])


@pytest.mark.parametrize("cfg", [KRON, URAND], ids=["kron", "urand"])
def test_triangles_match_trace_of_cube(cfg):
    g, a = _pair(cfg, 14)
    want = int(round((a @ a).multiply(a).sum() / 6))
    assert reference.triangles(g) == want
    assert reference.triangles(g, chunk=1000) == want
