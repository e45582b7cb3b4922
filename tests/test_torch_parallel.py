"""The port's multi-device layer (gardenia_tpu_torch/parallel) against the
JAX package's on the CPU: the partitions in process, equal array for
array; the solvers on gloo groups of 1, 2 and 4 CPU ranks (one spawn a
group for the whole file), held to gardenia_tpu.parallel's *_dist on the
8 virtual CPU devices of tests/conftest.py, to the serial oracles and, at
one rank, to the port's single-device solvers."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest has set the 8 CPU devices)

from gardenia_tpu import parallel as JD
from gardenia_tpu.core.generate import generate_graph as jax_generate
from gardenia_tpu.core.relabel import relabeled as jax_relabeled
from gardenia_tpu.parallel import partition as JP
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.parallel import call_each, run_on_ranks
from gardenia_tpu_torch.parallel import partition as TP
from gardenia_tpu_torch import parallel as TD

from tests.conftest import random_graph

MSBFS_SOURCES = np.arange(8)
# (case, port solver, JAX solver, graph, args, kwargs)
CASES = [
    ("pr hybrid rmat10", TD.pr_solver_dist, JD.pr_solver_dist, "rmat10",
     (), {}),
    ("pr ell rmat10", TD.pr_solver_dist, JD.pr_solver_dist, "rmat10", (),
     {"layout": "ell"}),
    ("pr hybrid directed", TD.pr_solver_dist, JD.pr_solver_dist,
     "directed", (), {}),
    ("pr ell directed", TD.pr_solver_dist, JD.pr_solver_dist, "directed",
     (), {"layout": "ell", "balance": "vertices"}),
    ("bfs hybrid rmat10", TD.bfs_solver_dist, JD.bfs_solver_dist, "rmat10",
     (0,), {}),
    ("bfs ell rmat10", TD.bfs_solver_dist, JD.bfs_solver_dist, "rmat10",
     (0,), {"layout": "ell"}),
    ("bfs hybrid directed", TD.bfs_solver_dist, JD.bfs_solver_dist,
     "directed", (3,), {}),
    ("bfs ell directed", TD.bfs_solver_dist, JD.bfs_solver_dist,
     "directed", (3,), {"layout": "ell", "balance": "vertices"}),
    ("msbfs rmat10", TD.bfs_multi_source_dist, JD.bfs_multi_source_dist,
     "rmat10", (MSBFS_SOURCES,), {}),
    ("tc rmat10", TD.tc_solver_dist, JD.tc_solver_dist, "rmat10", (), {}),
    ("vc rmat10", TD.vc_solver_dist, JD.vc_solver_dist, "rmat10", (), {}),
    ("scc directed", TD.scc_solver_dist, JD.scc_solver_dist, "directed",
     (), {}),
    ("scc rmat10", TD.scc_solver_dist, JD.scc_solver_dist, "rmat10", (),
     {}),
]
NAMES = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def graphs():
    """{name: (JAX package Graph, port Graph on the same arrays)}: the
    JAX dryrun's graph (R-MAT-10, degree 8, symmetrized) and a directed
    random graph with unreachable vertices."""
    out = {}
    for name, gj in (
            ("rmat10", jax_generate("rmat", scale=10, degree=8,
                                    symmetrize=True, need_reverse=True)),
            ("directed", random_graph(m=150, avg_deg=2, seed=4))):
        out[name] = (gj, from_csr_of(gj))
    return out


@pytest.fixture(scope="module")
def port_runs(graphs):
    """n -> {case: port result}, one gloo group of n CPU ranks a size."""
    cache = {}

    def get(n):
        if n not in cache:
            calls = [(fn, (graphs[gname][1], *args), kw)
                     for _, fn, _, gname, args, kw in CASES]
            cache[n] = dict(zip(NAMES, run_on_ranks(call_each, n, "cpu",
                                                    calls)[0]))
        return cache[n]
    return get


@pytest.fixture(scope="module")
def jax_runs(graphs):
    """n -> {case: the JAX package's *_dist result on an n-device mesh}."""
    cache = {}

    def get(n):
        if n not in cache:
            mesh = JD.make_mesh(n)
            cache[n] = {name: jfn(graphs[gname][0], *args, mesh=mesh, **kw)
                        for name, _, jfn, gname, args, kw in CASES}
        return cache[n]
    return get


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _same_partition(a, b) -> bool:
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    return len(np.unique(ia * (ib.max() + 1) + ib)) == \
        len(np.unique(ib)) == len(np.unique(ia))


# ---- the solvers against the JAX package's --------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", [c for c in NAMES if c.startswith("pr ")])
def test_pr_dist_matches_jax(port_runs, jax_runs, n, name):
    got, want = port_runs(n)[name], jax_runs(n)[name]
    it = int(want.iterations)
    assert got.iterations == it
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-6, rtol=0)
    # the trace as tests/test_torch_pr.py holds the single-device one: a
    # late error is an L1 sum of differences of nearly equal f32 scores
    # (~1e-8 of noise whatever its size), and JAX's hybrid sweep takes its
    # operand as two bf16 terms (~2^-16 relative)
    tol = {"rtol": 2e-3} if "hybrid" in name else {"rtol": 1e-5,
                                                     "atol": 1e-7}
    np.testing.assert_allclose(got.errors.numpy()[:it],
                               np.asarray(want.errors)[:it], **tol)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", [c for c in NAMES if c.startswith("bfs ")])
def test_bfs_dist_matches_jax_and_oracle(graphs, port_runs, jax_runs, n,
                                         name):
    _, _, _, gname, (src,), _ = _case(name)
    got = port_runs(n)[name].dist.numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_runs(n)[name].dist))
    np.testing.assert_array_equal(got, oracles.bfs_serial(graphs[gname][0],
                                                          src))


@pytest.mark.parametrize("n", [2, 4])
def test_msbfs_dist_columns_equal_serial_bfs(graphs, port_runs, jax_runs, n):
    got = port_runs(n)["msbfs rmat10"]
    gj = graphs["rmat10"][0]
    assert tuple(got.dist.shape) == (gj.m, len(MSBFS_SOURCES))
    for j, s in enumerate(MSBFS_SOURCES):
        np.testing.assert_array_equal(got.dist[:, j].numpy(),
                                      oracles.bfs_serial(gj, int(s)))
    assert got.iterations == int(jax_runs(n)["msbfs rmat10"].iterations)


def test_msbfs_dist_needs_the_mesh_to_divide_the_sources(graphs):
    gj, gt = graphs["rmat10"]
    with pytest.raises(ValueError, match="must divide"):
        JD.bfs_multi_source_dist(gj, np.arange(5), mesh=JD.make_mesh(2))
    # raised before any collective: a rank's view of a 2-rank group
    mesh = SimpleNamespace(size=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        TD.bfs_multi_source_dist(gt, np.arange(5), mesh=mesh)


@pytest.mark.parametrize("n", [2, 4])
def test_tc_dist_matches_jax_and_oracle(graphs, port_runs, jax_runs, n):
    got = port_runs(n)["tc rmat10"]
    assert got == jax_runs(n)["tc rmat10"]
    assert got == oracles.tc_serial(graphs["rmat10"][0].oriented())


@pytest.mark.parametrize("n", [2, 4])
def test_vc_dist_colours_equal_jax(graphs, port_runs, jax_runs, n):
    got, want = port_runs(n)["vc rmat10"], jax_runs(n)["vc rmat10"]
    colors = got.colors.numpy()
    assert oracles.vc_check(graphs["rmat10"][0], colors)
    diff = np.flatnonzero(colors != np.asarray(want.colors))
    assert diff.size == 0, f"colours differ from JAX's at vertices {diff}"
    assert (got.num_colors, got.iterations) == \
        (int(want.num_colors), int(want.iterations))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["scc directed", "scc rmat10"])
def test_scc_dist_matches_jax_and_oracle(graphs, port_runs, jax_runs, n,
                                         name):
    gname = _case(name)[3]
    root = port_runs(n)[name].scc_root.numpy()
    want = jax_runs(n)[name]
    assert _same_partition(root, np.asarray(want.scc_root))
    assert _same_partition(root, oracles.scc_serial(graphs[gname][0]))
    assert port_runs(n)[name].iterations == int(want.iterations)


def test_ranks_return_the_same_result(graphs):
    """Every rank assembles the whole answer."""
    gt = graphs["directed"][1]
    a, b = run_on_ranks(call_each, 2, "cpu",
                        [(TD.pr_solver_dist, (gt,), {}),
                         (TD.bfs_solver_dist, (gt, 3), {})])
    assert torch.equal(a[0].scores, b[0].scores)
    assert torch.equal(a[1].dist, b[1].dist)


# ---- one rank: the port's single-device solvers ---------------------------

@pytest.mark.parametrize("name", NAMES)
def test_dist_on_one_rank_equals_single_device(graphs, port_runs, name):
    from gardenia_tpu_torch.solvers.bfs import bfs_multi_source, bfs_pull
    from gardenia_tpu_torch.solvers.pr import pr_solver
    from gardenia_tpu_torch.solvers.scc import scc_solver
    from gardenia_tpu_torch.solvers.tc import tc_solver
    got = port_runs(1)[name]
    _, _, _, gname, args, kw = _case(name)
    g = graphs[gname][1]
    kernel = name.split()[0]
    if kernel == "pr":
        want = pr_solver(g, layout=kw.get("layout", "hybrid"), device="cpu")
        assert got.iterations == want.iterations
        np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(),
                                   atol=1e-6, rtol=0)
        it = want.iterations
        np.testing.assert_allclose(got.errors.numpy()[:it],
                                   want.errors.numpy()[:it], rtol=1e-5,
                                   atol=1e-7)
    elif kernel == "bfs":
        want = bfs_pull(g, args[0], device="cpu")
        assert torch.equal(got.dist, want.dist)
    elif kernel == "msbfs":
        want = bfs_multi_source(g, args[0], device="cpu")
        assert torch.equal(got.dist, want.dist)
        assert got.iterations == want.iterations
    elif kernel == "tc":
        assert got == tc_solver(g, device="cpu")
    elif kernel == "vc":
        # the single-device solver ends with a sequential core pass (V1)
        # and may stop sooner: one rank of the speculative cascade is the
        # JAX package's one-device run, exactly
        want = JD.vc_solver_dist(graphs[gname][0], mesh=JD.make_mesh(1))
        np.testing.assert_array_equal(got.colors.numpy(),
                                      np.asarray(want.colors))
    else:
        want = scc_solver(g, device="cpu")
        assert _same_partition(got.scc_root.numpy(),
                               want.scc_root.numpy())


# ---- the partitions, in process: equal to the JAX package's ---------------

@pytest.fixture(scope="module")
def relabelled():
    """(JAX, port) Graphs of a directed degree-relabelled R-MAT-10, whose
    hybrid layouts hold dense panels in every shard."""
    gj = jax_relabeled(jax_generate("rmat", scale=10, degree=8,
                                    symmetrize=False,
                                    need_reverse=True)).graph
    return gj, from_csr_of(gj)


def _host(x):
    """A JAX-side or port-side array as numpy (bf16 as f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _equal_buckets(jb, tb):
    assert len(jb) == len(tb)
    for bj, bt in zip(jb, tb):
        for x, y in zip(bj, bt):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(_host(x), _host(y))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_edge_balanced_bounds_matches_jax(relabelled, n):
    gj, _ = relabelled
    for rp in (gj.rowptr, gj.in_rowptr, np.zeros(9, np.int64)):
        np.testing.assert_array_equal(TP.edge_balanced_bounds(rp, n),
                                      JP.edge_balanced_bounds(rp, n))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("balance", ["edges", "vertices"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_partition_ell_1d_matches_jax(relabelled, n, balance, reverse):
    gj, gt = relabelled
    pj = JP.partition_ell_1d(gj, n, reverse=reverse, balance=balance)
    pt = TP.partition_ell_1d(gt, n, reverse=reverse, balance=balance)
    np.testing.assert_array_equal(pt.bounds, pj.bounds)
    assert pt.rows_per_shard == pj.rows_per_shard
    _equal_buckets(pj.ell.buckets, pt.ell.buckets)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("balance", ["edges", "vertices"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_partition_hybrid_1d_matches_jax(relabelled, n, balance, reverse):
    gj, gt = relabelled
    hj = JP.partition_hybrid_1d(gj, n, reverse=reverse, balance=balance)
    ht = TP.partition_hybrid_1d(gt, n, reverse=reverse, balance=balance)
    np.testing.assert_array_equal(ht.bounds, hj.bounds)
    assert ht.rows_per_shard == hj.rows_per_shard
    assert [p[0] for p in ht.panels] == [p[0] for p in hj.panels]
    assert len(ht.panels) > 0
    _equal_buckets([p[1:] for p in hj.panels], [p[1:] for p in ht.panels])
    _equal_buckets(hj.rem.buckets, ht.rem.buckets)


@pytest.mark.parametrize("kind", ["unweighted", "weighted", "uniform ax",
                                  "ax by shard"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_partition_hybrid_stacked_matches_jax(relabelled, n, kind):
    """Weighted panels (f32 / bf16 by value), the constant-value scale,
    and values that are constant within each shard but not across them
    (every shard rebuilt with factor_scale=False)."""
    gj, gt = relabelled
    kw = {}
    if kind == "weighted":
        gj = jax_generate("rmat", scale=9, degree=8, symmetrize=True,
                          weighted=True)
        gt = from_csr_of(gj)
        kw = {"weighted": True}
    elif kind == "uniform ax":
        kw = {"ax": np.full(gj.nnz, 0.2, np.float32)}
    elif kind == "ax by shard":
        bounds = JP.edge_balanced_bounds(gj.rowptr, n)
        shard = np.searchsorted(bounds, np.repeat(
            np.arange(gj.m), np.diff(gj.rowptr)), side="right") - 1
        kw = {"ax": (shard + 2).astype(np.float32)}
    sj = JP.partition_hybrid_stacked(gj, n, **kw)
    st = TP.partition_hybrid_stacked(gt, n, **kw)
    np.testing.assert_array_equal(st.bounds, sj.bounds)
    assert st.rows_per_shard == sj.rows_per_shard
    assert st.hyb.scale == sj.hyb.scale
    assert [p.width for p in st.hyb.dense] == [p.width for p in sj.hyb.dense]
    for pj, pt in zip(sj.hyb.dense, st.hyb.dense):
        assert str(pt.panel.dtype).split(".")[-1] == str(
            np.asarray(pj.panel).dtype)
        for x, y in ((pj.panel, pt.panel), (pj.src, pt.src),
                     (pj.rows, pt.rows)):
            np.testing.assert_array_equal(_host(x), _host(y))
    _equal_buckets([(b.row_ids, b.cols, b.vals) for b in sj.hyb.rem.buckets],
                   [(b.row_ids, b.cols, b.vals) for b in st.hyb.rem.buckets])
    assert tuple(st.hyb.rem_dst.shape) == np.asarray(sj.hyb.rem_dst).shape


@pytest.mark.parametrize("layout", ["ell", "hybrid"])
@pytest.mark.parametrize("n", [1, 3])
def test_rank_shard_is_its_slice_of_the_stacked_form(relabelled, n, layout):
    """What a rank builds alone equals its slice of the stacked form
    without the padding slots (n = 3 does not divide the vertex count)."""
    _, gt = relabelled
    for s in range(n):
        if layout == "ell":
            full = TP.partition_ell_1d(gt, n, reverse=True)
            sh = TP.ell_shard(gt, n, s, reverse=True)
            buckets, rem = full.ell.buckets, sh.mat
        else:
            full = TP.partition_hybrid_1d(gt, n, reverse=True)
            sh = TP.hybrid_shard(gt, n, s, reverse=True)
            buckets, rem = full.rem.buckets, sh.mat.rem
            mbB = full.rows_per_shard // 128
            mine = {p.width: p for p in sh.mat.dense}
            for w, panel, src, rows in full.panels:
                keep = rows[s] != mbB
                p = mine.pop(w, None)
                if p is None:
                    assert not keep.any()
                    continue
                assert torch.equal(p.panel, panel[s][torch.from_numpy(keep)])
                np.testing.assert_array_equal(p.src.numpy(), src[s][keep])
                np.testing.assert_array_equal(p.rows.numpy(), rows[s][keep])
            assert not mine
        assert (sh.lo, sh.hi) == full.shard_range(s)
        assert sh.ranges.rows_per_shard == full.rows_per_shard
        mb = full.rows_per_shard
        widths = {b.cols.shape[0]: b for b in rem.buckets}
        for rids, cols, _ in buckets:
            real = rids[s] != mb
            b = widths.get(cols.shape[1])
            if b is None:
                assert not real.any()
                continue
            mine = b.row_ids.numpy() != mb
            np.testing.assert_array_equal(b.row_ids.numpy()[mine],
                                          rids[s][real])
            np.testing.assert_array_equal(b.cols.numpy()[:, mine],
                                          cols[s][:, real])


def test_padded_maps_invert(relabelled):
    _, gt = relabelled
    p = TP.partition_ell_1d(gt, 3)
    x = np.arange(gt.m, dtype=np.int64)
    padded = p.to_padded(x, -1)
    np.testing.assert_array_equal(p.from_padded(padded), x)
    np.testing.assert_array_equal(padded[p.pad_map(x)], x)
    np.testing.assert_array_equal(
        p.from_padded(torch.from_numpy(padded)).numpy(), x)


def test_graph_pickles_without_its_views(graphs):
    """What a rank receives: the arrays, not the cache of views (which may
    hold device tensors)."""
    import pickle
    from gardenia_tpu_torch.core import views
    g = from_csr_of(graphs["directed"][0])
    views.relabeled_hybrid(g, "cpu")
    assert g._device_cache
    h = pickle.loads(pickle.dumps(g))
    assert h._device_cache == {}
    np.testing.assert_array_equal(h.colidx, g.colidx)
    np.testing.assert_array_equal(h.in_colidx, g.in_colidx)
    assert (h.m, h.n, h.symmetric) == (g.m, g.n, g.symmetric)


def test_describe_names_backend_and_devices():
    from gardenia_tpu_torch.parallel import describe
    assert describe(3, "cpu") == "3 ranks (gloo, cpu x3)"
