"""The port's own host code (gardenia_tpu_torch.core, .native, .verify —
copies of the JAX package's, so that the port imports nothing of it)
against the JAX package's on the same inputs: generators, relabelling,
the CSR builders (native and numpy), binary and text I/O, and the serial
oracles, each equal array by array."""

import numpy as np
import pytest

from gardenia_tpu import native as jnative
from gardenia_tpu.core import build as jbuild
from gardenia_tpu.core import io as jio
from gardenia_tpu.core import types as jtypes
from gardenia_tpu.core.generate import generate_graph as jgenerate
from gardenia_tpu.core.graph import load_graph as jload_graph
from gardenia_tpu.core.relabel import degree_relabel as jdegree_relabel
from gardenia_tpu.verify import oracles as joracles
from gardenia_tpu.verify import compare as jcompare

from gardenia_tpu_torch import native as tnative
from gardenia_tpu_torch.core import build as tbuild
from gardenia_tpu_torch.core import io as tio
from gardenia_tpu_torch.core import types as ttypes
from gardenia_tpu_torch.core.generate import generate_graph as tgenerate
from gardenia_tpu_torch.core.graph import Graph, from_csr_of
from gardenia_tpu_torch.core.graph import load_graph as tload_graph
from gardenia_tpu_torch.core.relabel import degree_relabel as tdegree_relabel
from gardenia_tpu_torch.core.relabel import relabeled
from gardenia_tpu_torch.verify import check
from gardenia_tpu_torch.verify import compare as tcompare
from gardenia_tpu_torch.verify import oracles as toracles


def _same_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_graph(t, j):
    """Every host array and flag of the two Graphs, the reverse CSR
    included."""
    assert type(t).__module__ == "gardenia_tpu_torch.core.graph"
    assert (t.m, t.n, t.nnz, t.symmetric) == (j.m, j.n, j.nnz, j.symmetric)
    for name in ("rowptr", "colidx", "in_rowptr", "in_colidx", "degrees"):
        _same_arrays(getattr(t, name), getattr(j, name))
    assert (t.weights is None) == (j.weights is None)
    if t.weights is not None:
        _same_arrays(t.weights, j.weights)


def test_types_are_the_references():
    names = [n for n in dir(jtypes) if n.isupper()]
    assert names
    for n in names:
        assert getattr(ttypes, n) == getattr(jtypes, n), n
    for x in (0, 1, 5, 1000, 1 << 20):
        assert ttypes.next_pow2(x) == jtypes.next_pow2(x)
        assert ttypes.round_up(x, 128) == jtypes.round_up(x, 128)


@pytest.mark.parametrize("kind,scale,sym,degree,weighted", [
    ("rmat", 10, True, 16, False), ("rmat", 11, False, 8, False),
    ("uniform", 10, True, 16, False), ("uniform", 10, False, 4, False),
    ("rmat", 9, True, 16, True)])
def test_generate_graph_matches_jax(kind, scale, sym, degree, weighted):
    kw = dict(scale=scale, degree=degree, symmetrize=sym,
              need_reverse=not sym, weighted=weighted)
    _same_graph(tgenerate(kind, **kw), jgenerate(kind, **kw))


@pytest.mark.parametrize("sym", [True, False])
def test_degree_relabel_matches_jax(sym):
    j = jgenerate("rmat", scale=10, symmetrize=sym, need_reverse=not sym)
    t = tgenerate("rmat", scale=10, symmetrize=sym, need_reverse=not sym)
    rt, rj = tdegree_relabel(t), jdegree_relabel(j)
    _same_arrays(rt.new_of_old, rj.new_of_old)
    _same_arrays(rt.old_of_new, rj.old_of_new)
    _same_graph(rt.graph, rj.graph)
    assert relabeled(t) is relabeled(t)           # cached on the graph


@pytest.mark.parametrize("symmetrize,weighted,self_loops", [
    (False, False, True), (True, False, True), (True, True, True),
    (False, True, False)])
def test_clean_edges_and_coo_to_csr_match_jax(symmetrize, weighted,
                                               self_loops):
    rng = np.random.default_rng(5)
    m, nnz = 300, 4000
    src = rng.integers(0, m, nnz).astype(np.int32)
    dst = rng.integers(0, m, nnz).astype(np.int32)
    wt = rng.integers(1, 50, nnz).astype(np.float64) if weighted else None
    kw = dict(num_rows=m, remove_self_loops=self_loops, symmetrize=symmetrize)
    t = tbuild.clean_edges(src, dst, wt, **kw)
    j = jbuild.clean_edges(src, dst, wt, **kw)
    for a, b in zip(t, j):
        assert (a is None) == (b is None)
        if a is not None:
            _same_arrays(a, b)
    for sorted_by_src in (True, False):
        args = (m, t[0], t[1], t[2])
        for a, b in zip(tbuild.coo_to_csr(*args, sorted_by_src=sorted_by_src),
                        jbuild.coo_to_csr(*args, sorted_by_src=sorted_by_src)):
            if a is not None:
                _same_arrays(a, b)
    rp, ci, _ = tbuild.coo_to_csr(m, t[0], t[1], sorted_by_src=True)
    for a, b in zip(tbuild.transpose_csr(m, rp, ci), jbuild.transpose_csr(
            m, rp, ci)):
        if a is not None:
            _same_arrays(a, b)
    for a, b in zip(tbuild.orient_dag(rp, ci), jbuild.orient_dag(rp, ci)):
        _same_arrays(a, b)


@pytest.mark.parametrize("symmetrize,weighted", [(False, False),
                                                 (True, False),
                                                 (True, True)])
def test_native_build_csr_matches_numpy_and_jax(symmetrize, weighted):
    """The port's C++ builder (compiled into gardenia_tpu_torch/_build)
    against its numpy path and against the JAX package's builder."""
    if not tnative.builder_available():
        pytest.skip("no g++ to build the native CSR builder")
    rng = np.random.default_rng(9)
    m, nnz = 500, 6000
    src = rng.integers(0, m, nnz).astype(np.int32)
    dst = rng.integers(0, m, nnz).astype(np.int32)
    wt = rng.integers(1, 9, nnz).astype(np.float64) if weighted else None
    got = tnative.build_csr(m, src, dst, wt, symmetrize=symmetrize)
    assert got is not None
    s, d, w = tbuild.clean_edges(src, dst, wt, num_rows=m,
                                 symmetrize=symmetrize)
    rp, ci, w = tbuild.coo_to_csr(m, s, d, w, sorted_by_src=True)
    _same_arrays(got[0], rp)
    _same_arrays(got[1], ci)
    if weighted:
        np.testing.assert_array_equal(got[2], w)
    ref = jnative.build_csr(m, src, dst, wt, symmetrize=symmetrize)
    if ref is not None:
        for a, b in zip(got, ref):
            if a is not None:
                _same_arrays(a, b)


def test_bin_round_trip_matches_jax(tmp_path):
    g = tgenerate("rmat", scale=9, symmetrize=True)
    vl = (np.arange(g.m) % 7).astype(np.uint8)
    prefix = str(tmp_path / "g")
    tio.write_bin_csr(prefix, g.rowptr, g.colidx, vl)
    for sym in (False, True):
        t = tload_graph(prefix, "bin", symmetrize=sym)
        j = jload_graph(prefix, "bin", symmetrize=sym)
        _same_graph(t, j)
        _same_arrays(t.vlabels, j.vlabels)
    t = tload_graph(prefix)                          # 'auto' finds .bin
    _same_arrays(t.rowptr, g.rowptr)
    _same_arrays(t.colidx, g.colidx)
    for a, b in zip(tio.read_bin_csr(prefix), jio.read_bin_csr(prefix)):
        _same_arrays(a, b)


MTX = """%%MatrixMarket matrix coordinate real general
% a comment
5 5 7
1 2 1.5
2 3 2.0
3 1 0.5
4 5 3.0
5 4 3.0
2 2 9.0
1 2 1.5
"""


@pytest.mark.parametrize("prefer_native", [True, False])
def test_mtx_parse_and_load_match_jax(tmp_path, prefer_native):
    path = tmp_path / "small.mtx"
    path.write_text(MTX)
    t = tio.parse_text(str(path), prefer_native=prefer_native)
    j = jio.parse_text(str(path), prefer_native=prefer_native)
    assert (t.num_rows, t.num_cols) == (j.num_rows, j.num_cols) == (5, 5)
    _same_arrays(t.src, j.src)
    _same_arrays(t.dst, j.dst)
    _same_arrays(t.wt, j.wt)
    for sym in (False, True):
        _same_graph(tload_graph(str(path), "mtx", symmetrize=sym,
                                need_reverse=True),
                    jload_graph(str(path), "mtx", symmetrize=sym,
                                need_reverse=True))


@pytest.mark.parametrize("sym", [True, False])
def test_oracles_match_jax(sym):
    j = jgenerate("rmat", scale=9, degree=8, symmetrize=sym,
                  need_reverse=not sym)
    t = from_csr_of(j)
    _same_arrays(toracles.cc_serial(t), joracles.cc_serial(j))
    if sym:
        assert toracles.tc_serial(t.oriented()) == \
            joracles.tc_serial(j.oriented()) > 0
    ts, ti, te = toracles.pagerank_serial(t)
    js, ji, je = joracles.pagerank_serial(j)
    _same_arrays(ts, js)
    assert ti == ji and te == je
    assert toracles.pagerank_push_residual(t, ts) == \
        joracles.pagerank_push_residual(j, js)
    x = np.random.default_rng(1).random(t.n).astype(np.float32)
    ax = np.ones(t.nnz, np.float32)
    _same_arrays(toracles.spmv_serial(t, ax, x), joracles.spmv_serial(j, ax, x))


def test_compare_and_check_match_jax(capsys):
    a = np.array([1.0, 2.0, 3.0])
    b = np.array([1.0, 2.5, 2.0])
    assert tcompare.maximum_relative_error(a, b) == \
        jcompare.maximum_relative_error(a, b)
    assert tcompare.l2_error(a, b) == jcompare.l2_error(a, b)
    assert check(True) and not check(False, "(x)")
    assert capsys.readouterr().out == "Correct\nWrong (x)\n"


def test_from_csr_of_shares_arrays_not_caches():
    j = jgenerate("rmat", scale=8, symmetrize=False, need_reverse=True)
    t = from_csr_of(j)
    assert isinstance(t, Graph) and t.rowptr is j.rowptr
    _same_graph(t, j)
    t._dev(("k",), lambda: 1)
    assert ("k",) not in j._device_cache
