"""The port's connected components (gardenia_tpu_torch.solvers.cc) and the
operators it runs against the JAX package on the same inputs, on the CPU:
K2's plain version against the Pallas min-select kernel in interpret
mode, spmv_hybrid_min_select and the ELL min-select, pointer jumping and
the frontier primitives, and cc_sv (both layouts) and cc_afforest element
by element.  Inputs come from numpy seeds; all comparisons are exact."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.core.graph import Graph
from gardenia_tpu.core.relabel import degree_relabel
from gardenia_tpu.ops import bsr as jbsr
from gardenia_tpu.ops import frontier as jfrontier
from gardenia_tpu.ops import semiring as jsr
from gardenia_tpu.ops.ell import build_ell as jbuild_ell
from gardenia_tpu.ops.pallas_bsr import dense_panel_minselect as jminsel
from gardenia_tpu.ops.pointer_jump import pointer_jump as jpointer_jump
from gardenia_tpu.ops.spmv import spmv_ell as jspmv_ell
from gardenia_tpu.solvers import cc as jcc
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch.cli import same_components
from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.ops import bsr as tbsr
from gardenia_tpu_torch.ops import frontier as tfrontier
from gardenia_tpu_torch.ops import minselect as tminsel
from gardenia_tpu_torch.ops import semiring as tsr
from gardenia_tpu_torch.ops.ell import build_ell as tbuild_ell
from gardenia_tpu_torch.ops.pointer_jump import pointer_jump, pointer_jump_n
from gardenia_tpu_torch.ops.spmv import spmv_ell as tspmv_ell
from gardenia_tpu_torch.solvers import cc as tcc

SENT = int(np.iinfo(np.int32).max)


def _weighted(kind, m=1500, avg_deg=12, seed=5):
    """Symmetric random graph whose weights pick one panel dtype:
    fractional -> f32, integers above 127 -> bf16, None -> int8."""
    g = random_graph(m=m, avg_deg=avg_deg, seed=seed, symmetric=True)
    if kind == "int8":
        return g, None
    rng = np.random.default_rng(11)
    w = (rng.random(g.nnz) + 0.5 if kind == "f32"
         else rng.integers(128, 256, g.nnz)).astype(np.float32)
    return g, w


def _build_both(g, w, thr=2):
    args = (g.rowptr, g.colidx, w)
    return (tbsr.build_hybrid(*args, num_cols=g.n, dense_threshold=thr),
            jbsr.build_hybrid(*args, num_cols=g.n, dense_threshold=thr))


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
def test_minselect_plain_matches_pallas(kind, monkeypatch):
    """The wrapper on CPU tensors (its plain version) against the JAX
    kernel in interpret mode, panel array by panel array, exact.  Labels
    of the padded operand slots are the sentinel, as the sweep pads."""
    monkeypatch.setattr(jbsr, "MAX_PANEL_WIDTH", 8)
    monkeypatch.setattr(tbsr, "MAX_PANEL_WIDTH", 8)
    g, w = _weighted(kind)
    t, j = _build_both(g, w)
    want = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
    assert len(t.dense) >= 2 and all(p.panel.dtype == want[kind]
                                     for p in t.dense)
    qx = (g.n + 127) // 128
    rng = np.random.default_rng(3)
    x2d = np.full(qx * 128, SENT, np.int32)
    x2d[:g.n] = rng.integers(0, 10 ** 6, g.n)
    x2d = x2d.reshape(qx, 128)
    before = tminsel.LAUNCHES
    for pt, pj in zip(t.dense, j.dense):
        R, W = pj.src.shape
        xg = x2d[np.asarray(pj.src)].reshape(R, W * 128, 1)
        with pltpu.force_tpu_interpret_mode():
            y_j = np.asarray(jminsel(jnp.asarray(pj.panel), jnp.asarray(xg),
                                     SENT, interpret=True))[..., 0]
        y_t = tminsel.dense_panel_minselect(pt.panel, pt.src,
                                            torch.from_numpy(x2d), SENT)
        assert y_t.shape == (R, 128) and y_t.dtype == torch.int32
        np.testing.assert_array_equal(y_t.numpy(), y_j)
        assert (y_j == SENT).any() and (y_j < SENT).any()
    assert tminsel.LAUNCHES == before       # CPU tensors: plain version


def test_minselect_plain_steps_and_negative_zero(monkeypatch):
    """The plain version gives the same rows in steps of any size, and a
    -0.0 cell is no edge (panel != 0)."""
    g, w = _weighted("f32", m=600)
    t = tbsr.build_hybrid(g.rowptr, g.colidx, w, num_cols=g.n,
                          dense_threshold=2)
    panel, src = t.dense[0].panel[:5], t.dense[0].src[:5]
    qx = (g.n + 127) // 128
    x2d = torch.from_numpy(np.random.default_rng(4).integers(
        0, 1000, (qx, 128)).astype(np.int32))
    whole = tminsel.dense_panel_minselect_plain(panel, src, x2d, SENT)
    monkeypatch.setattr(tminsel, "PLAIN_STEP_CELLS", 1)
    torch.testing.assert_close(
        tminsel.dense_panel_minselect_plain(panel, src, x2d, SENT), whole)
    panel = panel.clone()
    panel[0, 0] = -0.0
    y = tminsel.dense_panel_minselect_plain(panel, src, x2d, SENT)
    assert int(y[0, 0]) == SENT


def test_minselect_wrapper_checks():
    g, _ = _weighted("int8", m=300, avg_deg=10, seed=2)
    p = tbsr.build_hybrid(g.rowptr, g.colidx, None, num_cols=g.n,
                          dense_threshold=4).dense[0]
    x2d = torch.zeros((3, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        tminsel.dense_panel_minselect(p.panel.to(torch.int16), p.src, x2d, 9)
    with pytest.raises(TypeError):
        tminsel.dense_panel_minselect(p.panel, p.src.long(), x2d, 9)
    with pytest.raises(TypeError):
        tminsel.dense_panel_minselect(p.panel, p.src, x2d.float(), 9)
    with pytest.raises(ValueError):
        tminsel.dense_panel_minselect(p.panel[:, :64], p.src, x2d, 9)
    with pytest.raises(ValueError):
        tminsel.dense_panel_minselect(p.panel, p.src, x2d[:, :64], 9)


@pytest.mark.parametrize("case", ["rmat12", "int8_split", "bf16", "f32",
                                  "directed"])
def test_spmv_hybrid_min_select_matches_jax(case, monkeypatch):
    """The whole min-select sweep: panels (split rows among them) and
    the ELL remainder, against JAX's and against the ELL-only sweep."""
    if case == "directed":
        g = random_graph(m=900, avg_deg=14, seed=7)
        w, thr = None, 2
    else:
        # a degree-relabelled R-MAT graph: dense panels and a remainder
        g = degree_relabel(generate_graph("rmat", scale=12, degree=16,
                                          symmetrize=True)).graph
        rng = np.random.default_rng(11)
        w = {"bf16": rng.integers(128, 256, g.nnz).astype(np.float32),
             "f32": (rng.random(g.nnz) + 0.5).astype(np.float32)}.get(case)
        thr = 16
    if case == "int8_split":
        monkeypatch.setattr(jbsr, "MAX_PANEL_WIDTH", 2)
        monkeypatch.setattr(tbsr, "MAX_PANEL_WIDTH", 2)
    t, j = _build_both(g, w, thr)
    assert t.dense and t.rem.buckets
    want = {"bf16": torch.bfloat16, "f32": torch.float32}.get(case,
                                                               torch.int8)
    assert all(p.panel.dtype == want for p in t.dense)
    if case == "int8_split":
        rows = torch.cat([p.rows for p in t.dense])
        assert len(rows) > len(torch.unique(rows))
    x = np.random.default_rng(6).integers(0, 10 ** 6, g.n).astype(np.int32)
    y_t = tbsr.spmv_hybrid_min_select(t, torch.from_numpy(x), num_rows=g.m,
                                      sentinel=SENT).numpy()
    # jitted: op by op, JAX's CPU dispatch takes seconds on these slabs
    y_j = np.asarray(jax.jit(functools.partial(
        jbsr.spmv_hybrid_min_select, num_rows=g.m, sentinel=SENT))(
            j, jnp.asarray(x)))
    np.testing.assert_array_equal(y_t, y_j)
    ell = tbuild_ell(g.rowptr, g.colidx, None, num_cols=g.n)
    y_e = tspmv_ell(ell, torch.from_numpy(x), semiring=tsr.I32_MIN_SELECT2,
                    num_rows=g.m).numpy()
    np.testing.assert_array_equal(y_t, y_e)
    if case in ("rmat12", "directed"):      # the other cases' ELL is rmat12's
        y_je = np.asarray(jax.jit(functools.partial(
            jspmv_ell, semiring=jsr.I32_MIN_SELECT2, num_rows=g.m))(
                jbuild_ell(g.rowptr, g.colidx, None, num_cols=g.n),
                jnp.asarray(x)))
        np.testing.assert_array_equal(y_e, y_je)
    assert (y_t == SENT).any() == (np.diff(g.rowptr) == 0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_pointer_jump_matches_jax(seed):
    """Random parent forests (parent id <= own id: no cycles but the
    roots' self-loops), a chain of 200 included."""
    rng = np.random.default_rng(seed)
    m = 5000
    parent = np.clip(np.arange(m) - rng.integers(0, 40, m), 0,
                     None).astype(np.int32)
    parent[:200] = np.maximum(np.arange(200) - 1, 0)  # a chain of 200
    got = pointer_jump(torch.from_numpy(parent)).numpy()
    want = np.asarray(jpointer_jump(jnp.asarray(parent)))
    np.testing.assert_array_equal(got, want)
    assert (got[got] == got).all() and (got[:200] == 0).all()
    once = parent[parent]
    two = pointer_jump_n(torch.from_numpy(parent), 2).numpy()
    np.testing.assert_array_equal(two, once[once])


@pytest.mark.parametrize("size_frac", [0.3, 1.0, 2.0])
def test_compact_mask_matches_jax(size_frac):
    """jnp.nonzero(size=, fill_value=): truncated at size, fill-padded."""
    mask = np.random.default_rng(2).random(1000) < 0.4
    size = max(1, int(mask.sum() * size_frac))
    got = tfrontier.compact_mask(torch.from_numpy(mask), size, 1000).numpy()
    want = np.asarray(jfrontier.compact_mask(jnp.asarray(mask), size, 1000))
    assert got.dtype == np.int32 and got.shape == (size,)
    np.testing.assert_array_equal(got, want)
    deg = np.arange(1000, dtype=np.int32)
    assert int(tfrontier.frontier_degree_sum(
        torch.from_numpy(mask), torch.from_numpy(deg))) == \
        int(jfrontier.frontier_degree_sum(jnp.asarray(mask),
                                          jnp.asarray(deg)))


@pytest.mark.parametrize("capacity", [64, 2048, 20000])
def test_expand_frontier_edges_matches_jax(capacity):
    """Frontier ids padded with m (rows of no edges), zero-degree rows
    inside the frontier, and capacities below, near and above the total:
    every output equal to JAX's where valid, and valid itself."""
    g = random_graph(m=700, avg_deg=9, seed=3)
    m = g.m
    rng = np.random.default_rng(8)
    ids = np.sort(rng.choice(m, 150, replace=False)).astype(np.int32)
    ids = np.concatenate([ids, np.full(106, m, np.int32)])
    rp32 = g.rowptr.astype(np.int32)
    js, jd, jv, je = (np.asarray(a) for a in jfrontier.expand_frontier_edges(
        jnp.asarray(rp32), jnp.asarray(g.colidx), jnp.asarray(ids), capacity))
    ts, td, tv, te = (a.numpy() for a in tfrontier.expand_frontier_edges(
        torch.from_numpy(g.rowptr.astype(np.int64)),
        torch.from_numpy(g.colidx), torch.from_numpy(ids), capacity))
    np.testing.assert_array_equal(tv, jv)
    assert tv.any()
    np.testing.assert_array_equal(ts[tv], js[jv])
    np.testing.assert_array_equal(td[tv], jd[jv])
    np.testing.assert_array_equal(te[tv], je[jv])
    # the valid slots are exactly the frontier's out-edges, in order
    want = np.concatenate([g.colidx[g.rowptr[v]:g.rowptr[v + 1]]
                           for v in ids[ids < m]])[:capacity]
    np.testing.assert_array_equal(td[tv], want)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(te, je)


GRAPHS = {
    "rmat10": lambda: generate_graph("rmat", scale=10, symmetrize=True),
    "rmat12": lambda: generate_graph("rmat", scale=12, symmetrize=True),
    "rmat10_directed": lambda: generate_graph("rmat", scale=10,
                                              symmetrize=False,
                                              need_reverse=True),
    "uniform10": lambda: generate_graph("uniform", scale=10,
                                        symmetrize=True),
    # takes a dense round (a min-select sweep over every edge) over both
    # directions' matrices
    "uniform10_directed_deg2": lambda: generate_graph(
        "uniform", scale=10, degree=2, symmetrize=False, need_reverse=True),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cc_matches_jax(name, monkeypatch):
    """cc_sv on both layouts and cc_afforest equal to the JAX package's
    element by element, with equal iteration counts, and to the serial
    oracle by the CLI's bijection check.  Rounds are logged, so the
    graphs that must take a dense round show that they did."""
    g = GRAPHS[name]()
    tg = from_csr_of(g)
    kinds = []
    dense_round = tcc._dense_round
    monkeypatch.setattr(tcc, "_dense_round", lambda ctx, comp: (
        kinds.append(ctx.layout), dense_round(ctx, comp))[1])
    expect = oracles.cc_serial(g)
    for layout in ("hybrid", "ell"):
        j = jcc.cc_sv(g, layout=layout)
        t = tcc.cc_sv(tg, layout=layout, device="cpu")
        assert t.comp.dtype == torch.int32 and t.comp.shape == (g.m,)
        np.testing.assert_array_equal(t.comp.numpy(), np.asarray(j.comp))
        assert t.iterations == int(j.iterations)
        assert same_components(t.comp.numpy(), expect)
    assert (kinds == ["hybrid", "ell"]) == ("deg" in name)
    j = jcc.cc_afforest(g)
    t = tcc.cc_afforest(tg, device="cpu")
    np.testing.assert_array_equal(t.comp.numpy(), np.asarray(j.comp))
    assert t.iterations == int(j.iterations)
    assert same_components(t.comp.numpy(), expect)
    default = tcc.cc_solver(tg, device="cpu")           # afforest
    np.testing.assert_array_equal(default.comp.numpy(), t.comp.numpy())


def test_cc_uniform14_dense_round_on_panels(monkeypatch):
    """Uniform-14, the graph on which the card's K2 runs inside a solve:
    its one dense round sweeps its 3 panel arrays, and the solve agrees
    with the serial oracle (the element-by-element comparison with JAX
    is test_cc_matches_jax's, at scale 10)."""
    g = generate_graph("uniform", scale=14)
    tg = from_csr_of(g)
    calls = []
    sweep = tbsr.spmv_hybrid_min_select
    monkeypatch.setattr(tbsr, "spmv_hybrid_min_select", lambda hyb, *a, **k: (
        calls.append(len(hyb.dense)), sweep(hyb, *a, **k))[1])
    t = tcc.cc_sv(tg, device="cpu")
    assert same_components(t.comp.numpy(), oracles.cc_serial(g))
    assert t.iterations == 2 and calls == [3]


def test_cc_edge_cases():
    """No edges: every vertex its own component, in both variants; an
    unknown layout or variant raises.  cc_sv is held to the JAX package,
    cc_afforest only to np.arange: the JAX cc_afforest raises a TypeError
    on a graph with no edges (gardenia_tpu/solvers/cc.py:317 gathers from
    an empty colidx), which the port guards against."""
    g = Graph(np.zeros(6, np.int64), np.zeros(0, np.int32), num_cols=5,
              symmetric=True)
    tg = from_csr_of(g)
    for layout in ("hybrid", "ell"):
        t = tcc.cc_sv(tg, layout=layout, device="cpu")
        j = jcc.cc_sv(g, layout=layout)
        np.testing.assert_array_equal(t.comp.numpy(), np.arange(5))
        np.testing.assert_array_equal(t.comp.numpy(), np.asarray(j.comp))
        assert t.iterations == int(j.iterations)
    np.testing.assert_array_equal(
        tcc.cc_afforest(tg, device="cpu").comp.numpy(), np.arange(5))
    with pytest.raises(ValueError):
        tcc.cc_sv(tg, layout="csr", device="cpu")
    with pytest.raises(ValueError):
        tcc.cc_solver(tg, variant="nope", device="cpu")


def test_cc_sv_builds_the_hybrid_layout_only_for_a_dense_round():
    """The hybrid layout's panels are set-up that no R-MAT solve uses: the
    solve runs in the relabelled id space without them, and the first
    dense round (uniform graphs take one) builds them."""
    from gardenia_tpu_torch.core import views

    def built(tg):
        g2 = views.relabel_maps(tg, "cpu")[0]
        return views._key("hybrid", "cpu", views._dir(g2, False)) \
            in g2._device_cache

    rmat = from_csr_of(generate_graph("rmat", scale=10, symmetrize=True))
    t = tcc.cc_sv(rmat, layout="hybrid", device="cpu")
    assert same_components(t.comp.numpy(), oracles.cc_serial(rmat))
    assert not built(rmat)
    uni = from_csr_of(generate_graph("uniform", scale=14))
    tcc.cc_sv(uni, device="cpu")
    assert built(uni)
