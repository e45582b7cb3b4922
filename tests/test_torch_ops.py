"""The port's operators (gardenia_tpu_torch.ops) against the JAX package on
the same inputs: the host builders array by array, spmv_ell, the panel
matmul's plain version against the Pallas kernel in interpret mode, and
spmv_hybrid.  Inputs come from numpy seeds; JAX runs on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.core.graph import Graph
from gardenia_tpu.core.relabel import degree_relabel
from gardenia_tpu.ops import bsr as jbsr
from gardenia_tpu.ops import semiring as jsr
from gardenia_tpu.ops.ell import build_ell as jbuild_ell
from gardenia_tpu.ops.ell import ell_stats as jell_stats
from gardenia_tpu.ops.pallas_bsr import dense_panel_matmul as jpanel
from gardenia_tpu.ops.spmv import spmv_ell as jspmv_ell
from gardenia_tpu.verify import oracles

import gardenia_tpu_torch
from gardenia_tpu_torch.ops import bsr as tbsr
from gardenia_tpu_torch.ops import panel as tpanel
from gardenia_tpu_torch.ops import semiring as tsr
from gardenia_tpu_torch.ops.ell import build_ell as tbuild_ell
from gardenia_tpu_torch.ops.ell import ell_stats as tell_stats
from gardenia_tpu_torch.ops.ell import from_jax_ell
from gardenia_tpu_torch.ops.spmv import spmv_ell as tspmv_ell


def _rmat12():
    g = generate_graph("rmat", scale=12, degree=16, symmetrize=True)
    return degree_relabel(g).graph


def _weighted(kind, m=300, avg_deg=10, seed=2):
    """Symmetric random graph with weights that pick one panel dtype:
    fractional -> f32, integers above 127 -> bf16."""
    g = random_graph(m=m, avg_deg=avg_deg, seed=seed, symmetric=True)
    rng = np.random.default_rng(11)
    w = (rng.random(g.nnz) + 0.5 if kind == "f32"
         else rng.integers(100, 256, g.nnz)).astype(np.float32)
    return Graph(g.rowptr, g.colidx, w, num_cols=g.n, symmetric=True)


def _np(t):
    """A port tensor as numpy (bf16 widened to f32) plus its dtype name."""
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(), \
        str(t.dtype).split(".")[-1]


def _assert_same_array(t, a):
    a = np.asarray(a)
    tv, tname = _np(t)
    assert tname == a.dtype.name
    np.testing.assert_array_equal(tv, a.astype(tv.dtype))


def _assert_same_ell(t, j):
    assert len(t.buckets) == len(j.buckets)
    for bt, bj in zip(t.buckets, j.buckets):
        _assert_same_array(bt.row_ids, bj.row_ids)
        _assert_same_array(bt.cols, bj.cols)
        assert (bt.vals is None) == (bj.vals is None)
        if bt.vals is not None:
            _assert_same_array(bt.vals, bj.vals)


def _assert_same_hybrid(t, j):
    assert len(t.dense) == len(j.dense)
    for pt, pj in zip(t.dense, j.dense):
        assert pt.width == pj.width
        _assert_same_array(pt.panel, pj.panel)
        _assert_same_array(pt.src, pj.src)
        _assert_same_array(pt.rows, pj.rows)
    _assert_same_ell(t.rem, j.rem)
    _assert_same_array(t.rem_dst, j.rem_dst)
    _assert_same_array(t.rem_src, j.rem_src)
    assert (t.rem_w is None) == (j.rem_w is None)
    if t.rem_w is not None:
        _assert_same_array(t.rem_w, j.rem_w)
    assert t.scale == j.scale


def _build_both(g, thr, w=None):
    args = (g.rowptr, g.colidx, w)
    return (tbsr.build_hybrid(*args, num_cols=g.n, dense_threshold=thr),
            jbsr.build_hybrid(*args, num_cols=g.n, dense_threshold=thr))


@pytest.mark.parametrize("case", ["rmat12", "f32_panels", "bf16_panels",
                                  "row_split", "block_cap"])
def test_build_hybrid_matches_jax(case, monkeypatch):
    """Exact equality of every array and dtype of the two builders."""
    w = None
    if case == "rmat12":
        g, thr = _rmat12(), 16
    elif case in ("f32_panels", "bf16_panels"):
        g, thr = _weighted(case.split("_")[0]), 4
        w = g.weights
    else:
        g, thr = random_graph(m=1500, avg_deg=12, seed=5,
                              symmetric=True), 2
        name, val = (("MAX_PANEL_WIDTH", 2) if case == "row_split"
                     else ("MAX_PANEL_BLOCKS", 8))
        monkeypatch.setattr(jbsr, name, val)
        monkeypatch.setattr(tbsr, name, val)
    t, j = _build_both(g, thr, w)
    assert t.dense, "the case must exercise the dense panels"
    _assert_same_hybrid(t, j)
    want = {"f32_panels": torch.float32,
            "bf16_panels": torch.bfloat16}.get(case, torch.int8)
    assert all(p.panel.dtype == want for p in t.dense)
    if case == "row_split":
        rows = torch.cat([p.rows for p in t.dense])
        assert len(rows) > len(torch.unique(rows))
    if case == "block_cap":
        assert all(p.src.numel() <= 8 or p.width > 8 for p in t.dense)


def test_build_ell_weighted_matches_jax():
    g = random_graph(m=500, avg_deg=9, seed=4, weighted=True)
    w = np.asarray(g.weights, np.float32)
    t = tbuild_ell(g.rowptr, g.colidx, w, num_cols=g.n, width_cap=16)
    j = jbuild_ell(g.rowptr, g.colidx, w, num_cols=g.n, width_cap=16)
    _assert_same_ell(t, j)


def _ell_input(graph):
    """(rowptr, colidx, weights or None, num_cols) of an ell_stats case."""
    if graph == "edgeless":
        return np.zeros(18, np.int64), np.zeros(0, np.int32), None, 17
    if graph.startswith("rmat10"):
        g = generate_graph("rmat", scale=10, degree=16, symmetrize=True)
    else:
        g = random_graph(m=300, avg_deg=7, seed=5, weighted=True)
    w = None
    if graph.endswith("_w"):
        w = (np.asarray(g.weights, np.float32) if g.weights is not None
             else np.random.default_rng(6).random(g.nnz).astype(np.float32))
    return g.rowptr, g.colidx, w, g.n


@pytest.mark.parametrize("opts", [
    {}, {"width_cap": 16}, {"width_cap": 16, "min_width": 1, "lane_align": 1},
    {"min_width": 4, "lane_align": 1}], ids=["defaults", "cap16",
                                             "cap16_align1", "min4_align1"])
@pytest.mark.parametrize("graph", ["random", "random_w", "rmat10", "rmat10_w",
                                   "edgeless"])
def test_ell_stats_matches_jax(graph, opts):
    """ell_stats of the port's build_ell equals the JAX function's on the
    JAX build of the same CSR, pad rows up to lane_align included; the
    R-MAT graph's hubs are split into several virtual rows at cap 16."""
    rowptr, colidx, w, n = _ell_input(graph)
    t = tbuild_ell(rowptr, colidx, w, num_cols=n, **opts)
    j = jbuild_ell(rowptr, colidx, w, num_cols=n, **opts)
    want = jell_stats(j)
    assert tell_stats(t) == want
    assert tell_stats(t.to("cpu")) == want
    assert tell_stats(from_jax_ell(j)) == want
    assert all(type(v) is int for v in tell_stats(t).values())
    if graph == "edgeless":
        assert want == {"buckets": 0, "virtual_rows": 0, "slots": 0}
    elif graph.startswith("rmat10") and opts.get("width_cap") == 16:
        deg = np.diff(rowptr)
        split = int((-(-deg // 16)).sum())       # virtual rows before pads
        assert split > int((deg > 0).sum())      # the hubs were split
        if opts.get("lane_align") == 1:
            assert want["virtual_rows"] == split
        else:
            assert want["virtual_rows"] > split


def test_parallel_bc_inf_matches_jax():
    from gardenia_tpu.parallel import bc as jpbc
    from gardenia_tpu_torch.parallel import bc as tpbc
    assert tpbc.INF == jpbc.INF
    assert tpbc.INF.dtype == jpbc.INF.dtype == np.int32


def test_from_jax_hybrid_matches_port_build():
    for g, thr, w in ((_rmat12(), 16, None),
                      (_weighted("bf16"), 4, _weighted("bf16").weights)):
        t, j = _build_both(g, thr, w)
        _assert_same_hybrid(tbsr.from_jax_hybrid(j), j)
        _assert_same_hybrid(t, j)


@pytest.mark.parametrize("sr_name,row_cut,masked", [
    ("F32_PLUS_TIMES", 0, False), ("F32_PLUS_TIMES", 7, False),
    ("F32_PLUS_TIMES", 0, True), ("I32_MIN_SELECT2", 0, False),
    ("I32_MIN_SELECT2", 7, False), ("I32_MIN_SELECT2", 0, True)])
def test_spmv_ell_matches_jax(sr_name, row_cut, masked):
    """Pad rows carry the row sentinel m; with row_cut > 0 the last rows
    fall outside num_rows too, and both sides must drop them.  Rows off
    the row mask keep their init value."""
    g = random_graph(m=400, avg_deg=7, seed=9, weighted=True)
    rng = np.random.default_rng(3)
    w = np.asarray(g.weights, np.float32)
    m = g.m - row_cut
    if sr_name == "F32_PLUS_TIMES":
        x = rng.random(g.n).astype(np.float32)
    else:
        x = rng.integers(0, 10 ** 6, g.n).astype(np.int32)
    tell = tbuild_ell(g.rowptr, g.colidx, w, num_cols=g.n)
    jell = jbuild_ell(g.rowptr, g.colidx, w, num_cols=g.n)
    assert any(int(b.row_ids.max()) == g.m for b in tell.buckets)
    init = rng.random(m).astype(np.float32) if sr_name[0] == "F" else None
    mask = rng.random(m) < 0.5 if masked else None
    y_t = tspmv_ell(tell, torch.from_numpy(x),
                    semiring=getattr(tsr, sr_name), num_rows=m,
                    init=None if init is None else torch.from_numpy(init),
                    row_mask=None if mask is None else torch.from_numpy(mask))
    y_j = np.asarray(jspmv_ell(jell, jnp.asarray(x),
                               semiring=getattr(jsr, sr_name), num_rows=m,
                               init=None if init is None
                               else jnp.asarray(init),
                               row_mask=None if mask is None
                               else jnp.asarray(mask)))
    assert y_t.shape == (m,)
    if sr_name == "F32_PLUS_TIMES":
        np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-6)
    else:
        np.testing.assert_array_equal(y_t.numpy(), y_j)


def test_scatter_into_drops_out_of_range():
    y = torch.zeros(4)
    out = tsr.F32_PLUS_TIMES.scatter_into(
        y, torch.tensor([0, 4, 9, 3, 0], dtype=torch.int32),
        torch.ones(5))
    np.testing.assert_array_equal(out.numpy(), [2, 0, 0, 1])
    out = tsr.I32_MIN_SELECT2.scatter_into(
        torch.full((3,), 50, dtype=torch.int32),
        torch.tensor([1, 3], dtype=torch.int32),
        torch.tensor([7, 1], dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), [50, 7, 50])


@pytest.mark.parametrize("panel_kind,S", [("int8", 1), ("int8", 8),
                                          ("f32", 1), ("f32", 8),
                                          ("int8", 16), ("int8", 128)])
def test_panel_matmul_plain_matches_pallas(panel_kind, S, monkeypatch):
    """The wrapper on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode, bucket by bucket."""
    if panel_kind == "int8":
        g, w = random_graph(m=1500, avg_deg=12, seed=5, symmetric=True), None
    else:
        g = _weighted("f32", m=1500, avg_deg=12, seed=5)
        w = g.weights
    monkeypatch.setattr(jbsr, "MAX_PANEL_WIDTH", 8)
    monkeypatch.setattr(tbsr, "MAX_PANEL_WIDTH", 8)
    t, j = _build_both(g, 2, w)
    assert len(t.dense) >= 2
    qx = (g.n + 127) // 128
    x3d = np.random.default_rng(S).random((qx, 128, S)).astype(np.float32)
    for pt, pj in zip(t.dense, j.dense):
        R, W = pj.src.shape
        xg = x3d[pj.src].reshape(R, W * 128, S)
        with pltpu.force_tpu_interpret_mode():
            y_j = np.asarray(jpanel(jnp.asarray(pj.panel), jnp.asarray(xg),
                                    S, split=False, interpret=True))
        y_t = tpanel.dense_panel_matmul(pt.panel, pt.src,
                                        torch.from_numpy(x3d), S)
        assert y_t.shape == (R, 128, S) and y_t.dtype == torch.float32
        scale = max(1e-9, float(np.abs(y_j).max()))
        assert np.abs(y_t.numpy() - y_j).max() / scale < 1e-5


@pytest.mark.parametrize("kind,thr", [("rmat12", 16), ("f32", 4),
                                      ("bf16", 4), ("uniform", 4),
                                      ("rmat12_init", 16)])
def test_spmv_hybrid_matches_jax_and_oracle(kind, thr):
    if kind.startswith("rmat12"):
        g, w = _rmat12(), None
    elif kind == "uniform":
        g = random_graph(m=300, avg_deg=8, seed=11, symmetric=True)
        w = np.full(g.nnz, 0.25, np.float32)      # scale-factored layout
    else:
        g = _weighted(kind)
        w = g.weights
    t, j = _build_both(g, thr, w)
    assert t.dense
    rng = np.random.default_rng(5)
    x = rng.random(g.n).astype(np.float32)
    init = rng.random(g.m).astype(np.float32) if "init" in kind else None
    y_t = tbsr.spmv_hybrid(t, torch.from_numpy(x), num_rows=g.m,
                           init=None if init is None
                           else torch.from_numpy(init)).numpy()
    y_j = np.asarray(jbsr.spmv_hybrid(
        j, jnp.asarray(x), num_rows=g.m, use_pallas=False,
        init=None if init is None else jnp.asarray(init)))
    Ax = np.ones(g.nnz, np.float32) if w is None else w
    y_o = oracles.spmv_serial(g, Ax, x, None if init is None else init)
    scale = float(np.abs(y_o).max())
    assert np.abs(y_t - y_j).max() / scale < 1e-4
    assert np.abs(y_t - y_o).max() / scale < 1e-4


def test_panel_wrapper_cpu_plain_and_checks():
    """On CPU tensors the wrapper takes the plain version and counts no
    launch; a wrong dtype or shape raises before anything runs."""
    g = random_graph(m=300, avg_deg=10, seed=2, symmetric=True)
    t = tbsr.build_hybrid(g.rowptr, g.colidx, None, num_cols=g.n,
                          dense_threshold=4)
    p = t.dense[0]
    x3d = torch.rand((3, 128, 1), generator=torch.Generator().manual_seed(0))
    y = tpanel.dense_panel_matmul(p.panel, p.src, x3d, 1)
    assert not any(tpanel.LAUNCHES.values())
    torch.testing.assert_close(
        y, tpanel.dense_panel_matmul_plain(p.panel, p.src, x3d, 1))
    with pytest.raises(TypeError):
        tpanel.dense_panel_matmul(p.panel.to(torch.int16), p.src, x3d, 1)
    with pytest.raises(TypeError):
        tpanel.dense_panel_matmul(p.panel, p.src.long(), x3d, 1)
    with pytest.raises(TypeError):
        tpanel.dense_panel_matmul(p.panel, p.src, x3d.double(), 1)
    with pytest.raises(ValueError):
        tpanel.dense_panel_matmul(p.panel[:, :64], p.src, x3d, 1)
    with pytest.raises(ValueError):
        tpanel.dense_panel_matmul(p.panel, p.src, x3d, 2)


def test_resolve_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        gardenia_tpu_torch.resolve_device("cuda")
    assert gardenia_tpu_torch.resolve_device("cpu") == torch.device("cpu")


# --- the batched path: spmv_segment, spmv_batched, spmv_hybrid_batched ----

def _directed10():
    return generate_graph("rmat", scale=10, degree=8, symmetrize=False,
                          need_reverse=True)


@pytest.mark.parametrize("sr_name,with_vals,with_init", [
    ("F32_PLUS_TIMES", False, False), ("F32_PLUS_TIMES", True, True),
    ("I32_MIN_SELECT2", False, True), ("I32_PLUS_TIMES", False, False)])
def test_spmv_segment_matches_jax(sr_name, with_vals, with_init):
    """COO scatter-combine against the JAX function, with row ids outside
    [0, m) (dropped by both) and column ids at n (the pad value).  f32
    sums within 1e-5 of max|y| (different summation orders); integer
    semirings exact."""
    from gardenia_tpu.ops.spmv import spmv_segment as jsegment
    from gardenia_tpu_torch.ops.spmv import spmv_segment as tsegment
    g = _directed10()
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(g.m, dtype=np.int32), np.diff(g.rowptr))
    cols = np.asarray(g.colidx, np.int32).copy()
    rows[::97] = g.m + 5                       # out of range: dropped
    cols[::89] = g.n                           # the pad slot
    perm = rng.permutation(len(rows))          # COO order is free
    rows, cols = rows[perm], cols[perm]
    sr_t, sr_j = getattr(tsr, sr_name), getattr(jsr, sr_name)
    integer = sr_t.dtype == torch.int32
    x = (rng.integers(0, 1000, g.n).astype(np.int32) if integer
         else rng.random(g.n).astype(np.float32))
    vals = rng.random(len(rows)).astype(np.float32) if with_vals else None
    init = x[::-1].copy()[:g.m] if with_init else None
    y_t = tsegment(torch.from_numpy(rows), torch.from_numpy(cols),
                   None if vals is None else torch.from_numpy(vals),
                   torch.from_numpy(x), semiring=sr_t, num_rows=g.m,
                   init=None if init is None else torch.from_numpy(init))
    y_j = np.asarray(jsegment(
        jnp.asarray(rows), jnp.asarray(cols),
        None if vals is None else jnp.asarray(vals), jnp.asarray(x),
        semiring=sr_j, num_rows=g.m,
        init=None if init is None else jnp.asarray(init)))
    assert y_t.shape == (g.m,) and y_t.dtype == sr_t.dtype
    if integer:
        np.testing.assert_array_equal(y_t.numpy(), y_j)
    else:
        assert np.abs(y_t.numpy() - y_j).max() / np.abs(y_j).max() < 1e-5


@pytest.mark.parametrize("S", [1, 3, 16, 128])
def test_spmv_batched_matches_jax(S):
    """The sorted segment sum against jax.ops.segment_sum: within 1e-5 of
    max|y| (f32, different summation orders), empty rows zero."""
    from gardenia_tpu.ops.spmv import spmv_batched as jbatched
    from gardenia_tpu_torch.ops.spmv import row_offsets, spmv_batched
    g = _directed10()
    rows = np.repeat(np.arange(g.m, dtype=np.int32), np.diff(g.rowptr))
    cols = np.asarray(g.colidx, np.int32)
    x = np.random.default_rng(S).random((g.n, S)).astype(np.float32)
    y_t = spmv_batched(torch.from_numpy(rows), torch.from_numpy(cols),
                       torch.from_numpy(x), num_rows=g.m)
    y_j = np.asarray(jbatched(jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(x), num_rows=g.m))
    assert y_t.shape == (g.m, S) and y_t.dtype == torch.float32
    assert np.abs(y_t.numpy() - y_j).max() / np.abs(y_j).max() < 1e-5
    empty = np.diff(g.rowptr) == 0
    assert empty.any() and not y_t.numpy()[empty].any()
    off = row_offsets(torch.from_numpy(rows), g.m)
    np.testing.assert_array_equal(off.numpy(), g.rowptr)
    y_o = spmv_batched(torch.from_numpy(rows), torch.from_numpy(cols),
                       torch.from_numpy(x), num_rows=g.m, offsets=off)
    assert torch.equal(y_o, y_t)


def _batched_case(kind):
    """(graph, weights or None, dense threshold)."""
    if kind == "rmat12":
        return _rmat12(), None, 16
    if kind == "directed10":
        return _directed10(), None, 100
    if kind == "scaled":                          # scale-factored layout
        g = random_graph(m=300, avg_deg=8, seed=11, symmetric=True)
        return g, np.full(g.nnz, 0.25, np.float32), 4
    # about 125 edges a block: some blocks dense, some in the weighted
    # remainder
    g = _weighted(kind, m=1500, avg_deg=6)
    return g, g.weights, 125


@pytest.mark.parametrize("S", [1, 3, 16, 128])
@pytest.mark.parametrize("kind", ["rmat12", "directed10", "scaled", "f32",
                                  "bf16"])
def test_spmv_hybrid_batched_matches_jax(kind, S):
    """An f32 operand within 1e-5 of max|y| of the JAX function with
    exact=True (its hi/lo split carries 2^-16; the port's CPU path is
    f32), of the panel-free spmv_batched and of the serial oracle column
    by column; a 0/1 bf16 mask exactly equal to the JAX function with
    exact=False (integer counts)."""
    from gardenia_tpu_torch.ops.spmv import spmv_batched
    g, w, thr = _batched_case(kind)
    t, j = _build_both(g, thr, w)
    assert t.dense and (kind == "scaled" or t.rem_dst.numel())
    assert (t.rem_w is not None) == (kind in ("f32", "bf16"))
    rng = np.random.default_rng(S)
    x = rng.random((g.n, S)).astype(np.float32)
    y_t = tbsr.spmv_hybrid_batched(t, torch.from_numpy(x), num_rows=g.m)
    assert y_t.shape == (g.m, S) and y_t.dtype == torch.float32
    y_j = np.asarray(jbsr.spmv_hybrid_batched(
        j, jnp.asarray(x), num_rows=g.m, exact=True, use_pallas=False))
    scale = float(np.abs(y_j).max())
    assert np.abs(y_t.numpy() - y_j).max() / scale < 1e-5
    Ax = np.ones(g.nnz, np.float32) if w is None else w
    for s in {0, S - 1}:
        y_o = oracles.spmv_serial(g, Ax, x[:, s])
        assert np.abs(y_t.numpy()[:, s] - y_o).max() / scale < 1e-5
    if w is None:
        rows = np.repeat(np.arange(g.m, dtype=np.int32), np.diff(g.rowptr))
        y_b = spmv_batched(torch.from_numpy(rows),
                           torch.from_numpy(np.asarray(g.colidx, np.int32)),
                           torch.from_numpy(x), num_rows=g.m)
        assert (y_t - y_b).abs().max() / scale < 1e-5
        mask = rng.random((g.n, S)) < 0.2
        c_t = tbsr.spmv_hybrid_batched(
            t, torch.from_numpy(mask).to(torch.bfloat16), num_rows=g.m)
        c_j = np.asarray(jbsr.spmv_hybrid_batched(
            j, jnp.asarray(mask, jnp.float32), num_rows=g.m, exact=False,
            use_pallas=False))
        np.testing.assert_array_equal(c_t.numpy(), c_j)
    assert not any(tpanel.LAUNCHES.values())     # on the CPU: plain only


@pytest.mark.parametrize("S", [1, 16, 128])
def test_panel_matmul_plain_bf16_operand_matches_pallas(S, monkeypatch):
    """The wrapper on CPU tensors with a bf16 operand (one bf16 pass)
    against the Pallas kernel in interpret mode on the same bf16 operand,
    split=False, bucket by bucket: the products are exact in f32 on both
    sides, so 1e-6 of max|y| covers the summation order."""
    g = random_graph(m=1500, avg_deg=12, seed=5, symmetric=True)
    monkeypatch.setattr(jbsr, "MAX_PANEL_WIDTH", 8)
    monkeypatch.setattr(tbsr, "MAX_PANEL_WIDTH", 8)
    t, j = _build_both(g, 2, None)
    qx = (g.n + 127) // 128
    x3d = torch.from_numpy(np.random.default_rng(S).random(
        (qx, 128, S)).astype(np.float32)).to(torch.bfloat16)
    x_np = x3d.float().numpy()
    for pt, pj in zip(t.dense, j.dense):
        R, W = pj.src.shape
        xg = jnp.asarray(x_np[pj.src].reshape(R, W * 128, S), jnp.bfloat16)
        with pltpu.force_tpu_interpret_mode():
            y_j = np.asarray(jpanel(jnp.asarray(pj.panel), xg, S, split=False,
                                    interpret=True))
        y_t = tpanel.dense_panel_matmul(pt.panel, pt.src, x3d, S)
        assert y_t.shape == (R, 128, S) and y_t.dtype == torch.float32
        assert np.abs(y_t.numpy() - y_j).max() / np.abs(y_j).max() < 1e-6
        torch.testing.assert_close(
            y_t, tpanel.dense_panel_matmul_plain(pt.panel, pt.src,
                                                 x3d.float(), S))


def test_panel_kernel_route_by_shape_and_type():
    """Which of K1's kernels a CUDA call takes: the CUDA-core kernel up to
    8 columns with an f32 operand and for f32 panels at any S, the
    tensor-core kernel beyond and for a bf16 operand."""
    i8, bf, f32 = torch.int8, torch.bfloat16, torch.float32
    route = tpanel.kernel_route
    assert [route(i8, f32, S) for S in (1, 8, 9, 128)] == \
        ["simt", "simt", "tc", "tc"]
    assert [route(bf, f32, S) for S in (1, 9)] == ["simt", "tc"]
    assert [route(i8, bf, S) for S in (1, 128)] == ["tc", "tc"]
    assert {route(f32, x, S) for x in (f32, bf) for S in (1, 128)} == {"simt"}
    assert tpanel.LAUNCHES == {"simt": 0, "tc": 0}


@pytest.mark.parametrize("S", [9, 100, 128, 136])
def test_panel_tc_column_padding_and_crop(S):
    """The 'tc' route's host code: S is padded to a multiple of 8 columns
    (TMA's 16-byte rows), zeros past S; S = 128 and 136 pay no copy; the
    output's crop gives back the first S columns."""
    Sp = tpanel.padded_columns(S)
    assert Sp % tpanel.TC_COL_ALIGN == 0 and S <= Sp < S + 8
    x = torch.rand((3, 128, S), generator=torch.Generator().manual_seed(S))
    xp = tpanel.pad_columns(x, Sp)
    assert xp.shape == (3, 128, Sp) and xp.is_contiguous()
    assert xp.data_ptr() % 16 == 0
    torch.testing.assert_close(xp[..., :S], x, rtol=0, atol=0)
    assert not xp[..., S:].any()
    if Sp == S:
        assert xp.data_ptr() == x.data_ptr()        # no copy
    out = torch.rand((2, 128, Sp))
    crop = tpanel.crop_columns(out, S)
    assert crop.shape == (2, 128, S) and crop.is_contiguous()
    torch.testing.assert_close(crop, out[..., :S], rtol=0, atol=0)
    assert (crop.data_ptr() == out.data_ptr()) == (Sp == S)
    bf = tpanel.pad_columns(x.to(torch.bfloat16), Sp)
    assert bf.dtype == torch.bfloat16 and not bf[..., S:].float().any()


@pytest.mark.parametrize("S", [9, 128])
def test_split_operand_plain_is_exact(S):
    """The plain version of the f32 operand's split: three bf16 terms whose
    f32 sum is x exactly (hi, then mid, then lo), zero past S; on a CPU
    tensor split_operand is the plain version and counts no launch."""
    rng = np.random.default_rng(S)
    x = torch.from_numpy((rng.random((4, 128, S)) * 10.0 ** rng.integers(
        -6, 6, (4, 128, S))).astype(np.float32))
    x[0, 0, 0] = 0.0
    terms = tpanel.split_operand(x)
    Sp = tpanel.padded_columns(S)
    assert terms.shape == (3, 4, 128, Sp) and terms.dtype == torch.bfloat16
    total = (terms[0].float() + terms[1].float()) + terms[2].float()
    assert torch.equal(total[..., :S], x)
    assert not terms[..., S:].float().any()
    # each term is the rounding of what the earlier ones left
    assert torch.equal(terms[0][..., :S], x.to(torch.bfloat16))
    torch.testing.assert_close(terms, tpanel.split_operand_plain(x),
                               rtol=0, atol=0)
    assert tpanel.SPLIT_LAUNCHES == {"split": 0}
    with pytest.raises(ValueError):
        tpanel.split_operand(x.to(torch.bfloat16))


@pytest.mark.parametrize("S", [9, 100, 136])
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_panel_tc_host_path_matches_plain(S, x_dtype):
    """What the 'tc' route hands its kernel, multiplied by the plain
    version: the padded bf16 operand, or the three split terms summed, over
    Sp columns and cropped to S, equals the plain product on the operand
    itself (products of small integers and bf16 terms are exact in f32;
    1e-6 of max|y| covers the order of the sums)."""
    g = random_graph(m=400, avg_deg=12, seed=4, symmetric=True)
    t = tbsr.build_hybrid(g.rowptr, g.colidx, None, num_cols=g.n,
                          dense_threshold=4)
    qx = (g.n + 127) // 128
    x = torch.from_numpy(np.random.default_rng(S).random(
        (qx, 128, S)).astype(np.float32))
    if x_dtype == "bf16":
        x = x.to(torch.bfloat16)
    Sp = tpanel.padded_columns(S)
    xt = tpanel.tc_operand(x)
    assert xt.shape == (1 if x_dtype == "bf16" else 3, qx, 128, Sp)
    assert xt.dtype == torch.bfloat16 and xt.is_contiguous()
    for p in t.dense:
        want = tpanel.dense_panel_matmul_plain(p.panel, p.src, x, S)
        got = tpanel.crop_columns(sum(
            tpanel.dense_panel_matmul_plain(p.panel, p.src, term, Sp)
            for term in xt), S)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= \
            1e-6 * float(want.abs().max())


@pytest.mark.parametrize("S", [1, 16, 128])
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_panel_matmul_arrays_is_one_call_per_array(S, x_dtype, monkeypatch):
    """dense_panel_matmul_arrays over a hybrid layout's panel arrays equals
    dense_panel_matmul on each; on CPU tensors it runs the plain version
    only: the operand is never split or padded for the kernel there, and
    no launch is counted."""
    g = random_graph(m=1500, avg_deg=12, seed=5, symmetric=True)
    monkeypatch.setattr(tbsr, "MAX_PANEL_WIDTH", 8)
    t = tbsr.build_hybrid(g.rowptr, g.colidx, None, num_cols=g.n,
                          dense_threshold=2)
    assert len(t.dense) >= 2
    qx = (g.n + 127) // 128
    x = torch.from_numpy(np.random.default_rng(S).random(
        (qx, 128, S)).astype(np.float32))
    if x_dtype == "bf16":
        x = x.to(torch.bfloat16)

    def refuse(*_):
        raise AssertionError("the CPU path made the kernel's operand")
    monkeypatch.setattr(tpanel, "tc_operand", refuse)
    monkeypatch.setattr(tpanel, "split_operand", refuse)
    got = tpanel.dense_panel_matmul_arrays(
        ((p.panel, p.src) for p in t.dense), x, S)
    assert len(got) == len(t.dense)
    for p, y in zip(t.dense, got):
        torch.testing.assert_close(
            y, tpanel.dense_panel_matmul(p.panel, p.src, x, S),
            rtol=0, atol=0)
    assert tpanel.LAUNCHES == {"simt": 0, "tc": 0}
    assert tpanel.dense_panel_matmul_arrays([], x, S) == []
    with pytest.raises(ValueError):
        tpanel.dense_panel_matmul_arrays(
            [(p.panel, p.src) for p in t.dense] + [(t.dense[0].panel[:, :64],
                                                   t.dense[0].src)], x, S)
