"""The port's SpMV (gardenia_tpu_torch.solvers.spmv, ops/spmv.make_push_pb,
the weighted views and the SpMV bench's apply loop) against the JAX
package and the serial product on the same numpy-seeded graphs, on the
CPU.  Tolerances (max|diff| / max|y|): port against JAX 1e-5 (f32
summation order), except against the JAX hybrid variant, whose operand
hi/lo bf16 split carries 2^-16 of its own; both against the serial
product below sqrt(eps) of f32, the CLI's check."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import random_graph
from tests.test_torch_ops import _assert_same_ell, _assert_same_hybrid

from gardenia_tpu.core.graph import Graph
from gardenia_tpu.ops import bsr as jbsr
from gardenia_tpu.ops.spmv import make_push_pb as jpush_pb
from gardenia_tpu.solvers.spmv import spmv_solver as jspmv
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.ops import panel as tpanel
from gardenia_tpu_torch.ops.spmv import make_push_pb as tpush_pb
from gardenia_tpu_torch.solvers import spmv as tspmv

SQRT_EPS = float(np.sqrt(np.finfo(np.float32).eps))
JAX_SPLIT_REL = 2.0 ** -16


def _graph(kind):
    """Dense enough that threshold-64 blocks exist (3 x 3 blocks of 128
    over 300 vertices and ~12k edges each way)."""
    if kind == "directed":
        return random_graph(m=300, avg_deg=40, seed=6)
    g = random_graph(m=300, avg_deg=40, seed=1, symmetric=True)
    if kind == "sym":
        return g
    rng = np.random.default_rng(2)
    w = {"int": rng.integers(1, 10, g.nnz),
         "f32": rng.random(g.nnz) + 0.5,
         "bf16": rng.integers(128, 256, g.nnz)}[kind].astype(np.float64)
    return Graph(g.rowptr, g.colidx, w, num_cols=g.n, symmetric=True)


def _values(g):
    return (np.full(g.nnz, 0.2, np.float32) if g.weights is None
            else np.asarray(g.weights, np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _transpose_product(g, Ax, x, y):
    """y + A^T x in f64, edge by edge."""
    out = np.zeros(g.n) if y is None else y.astype(np.float64)
    src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    np.add.at(out, g.colidx, Ax.astype(np.float64) * x[src])
    return out


@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("kind", ["sym", "int", "f32", "directed"])
@pytest.mark.parametrize("variant", ["ell", "hybrid", "segment", "push_pb",
                                     "auto"])
def test_spmv_variants_match_jax_and_oracle(variant, kind, with_y):
    """Every variant on unweighted (0.2) and weighted graphs, with and
    without y: the port against the JAX solver and both against the
    serial product (push_pb: the transpose's)."""
    g = _graph(kind)
    rng = np.random.default_rng(3)
    x = rng.random(g.n).astype(np.float32)
    y = rng.random(g.m).astype(np.float32) if with_y else None
    got = tspmv.spmv_solver(from_csr_of(g), x=x, y=y, variant=variant,
                            device="cpu")
    assert got.dtype == torch.float32 and got.shape == (g.m,)
    want = np.asarray(jspmv(g, x=x, y=y, variant=variant))
    Ax = _values(g)
    expect = (_transpose_product(g, Ax, x, y) if variant == "push_pb"
              else oracles.spmv_serial(g, Ax, x, y))
    limit = JAX_SPLIT_REL if variant == "hybrid" else 1e-5
    assert _rel(got.numpy(), want) <= limit
    assert _rel(got.numpy(), expect) < SQRT_EPS
    assert _rel(want, expect) < SQRT_EPS


@pytest.mark.parametrize("kind", ["sym", "int", "f32", "bf16"])
def test_spmv_hybrid_layout_has_dense_panels(kind):
    """The hybrid variant's threshold-64 layout holds dense panels in
    every case: uniform 0.2 values factor into int8 counts x 0.2, small
    integers stay int8, integers up to 256 take bf16 and fractions f32;
    the result is within 1e-5 of the port's own ell variant and of the
    JAX ell variant (both f32 exact)."""
    g = _graph(kind)
    tg = from_csr_of(g)
    Ax = _values(g)
    run = tspmv.hybrid_layout(tg, Ax, torch.device("cpu"))
    want_dtype = {"sym": torch.int8, "int": torch.int8, "f32": torch.float32,
                  "bf16": torch.bfloat16}[kind]
    assert run.hyb.dense and all(p.panel.dtype == want_dtype
                                 for p in run.hyb.dense)
    assert run.hyb.scale == (np.float32(0.2) if kind == "sym" else 1.0)
    x = np.random.default_rng(4).random(g.n).astype(np.float32)
    y_h = tspmv.spmv_solver(tg, Ax, x, variant="hybrid", device="cpu")
    y_e = tspmv.spmv_solver(tg, Ax, x, variant="ell", device="cpu")
    assert _rel(y_h.numpy(), y_e.numpy()) <= 1e-5
    assert _rel(y_h.numpy(), np.asarray(jspmv(g, Ax, x, variant="ell"))) \
        <= 1e-5
    # the layout is cached with the array: the next call reuses it
    assert tspmv.hybrid_layout(tg, Ax, torch.device("cpu")) is run


def test_spmv_hybrid_layout_equals_jax_build():
    """The port's threshold-64 layout equals the JAX build of the same
    relabelled graph and reordered values, array by array."""
    from gardenia_tpu.core.build import csr_to_coo
    from gardenia_tpu.core.relabel import relabeled
    g = _graph("int")
    Ax = _values(g)
    rel = relabeled(g)
    src, dst = csr_to_coo(g.rowptr, g.colidx)
    order = np.lexsort((rel.new_of_old[dst], rel.new_of_old[src]))
    j = jbsr.build_hybrid(rel.graph.rowptr, rel.graph.colidx, Ax[order],
                          num_cols=g.n, dense_threshold=64)
    run = tspmv.hybrid_layout(from_csr_of(g), Ax, torch.device("cpu"))
    _assert_same_hybrid(run.hyb, j)


@pytest.mark.parametrize("kind", ["sym", "f32", "directed"])
def test_make_push_pb_is_the_transpose_product(kind):
    """y[i] = sum_j A[j, i] x[j]: the port's push against the JAX push and
    a dense transpose product, weighted and unweighted (ones)."""
    g = _graph(kind)
    x = np.random.default_rng(5).random(g.m).astype(np.float32)
    for w in (None, g.weights):
        got = tpush_pb(from_csr_of(g), w, device="cpu")(torch.from_numpy(x))
        want = np.asarray(jpush_pb(g, weights=w)(jnp.asarray(x)))
        dense = np.zeros((g.m, g.n))
        src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
        np.add.at(dense, (src, g.colidx), 1.0 if w is None else w)
        assert got.shape == (g.n,)
        assert _rel(got.numpy(), want) <= 1e-5
        assert _rel(got.numpy(), dense.T @ x) <= 1e-5


def test_spmv_auto_is_ell_on_the_cpu_and_variants_are_checked():
    g = from_csr_of(_graph("sym"))
    a = tspmv.spmv_solver(g, variant="auto", device="cpu")
    e = tspmv.spmv_solver(g, variant="ell", device="cpu")
    assert torch.equal(a, e)
    assert ("torch", "spmv_hybrid", "cpu") not in \
        {k[:3] for k in g._device_cache}
    with pytest.raises(ValueError, match="unknown SpMV variant"):
        tspmv.spmv_solver(g, variant="nope", device="cpu")


@pytest.mark.parametrize("kind", ["int", "f32", "directed"])
def test_weighted_views_match_jax(kind):
    """views.ell with weighted= equals the JAX Graph's ell(weighted=True)
    array by array, forward and reverse; an unweighted graph's weighted
    ELL holds ones, and the unweighted view keeps its own cache entry."""
    g = _graph(kind)
    tg = from_csr_of(g)
    for reverse in (False, True):
        _assert_same_ell(views.ell(tg, "cpu", reverse=reverse,
                                   weighted=True),
                         g.ell(reverse=reverse, weighted=True))
    assert views.ell(tg, "cpu") is not views.ell(tg, "cpu", weighted=True)


def test_spmv_bench_applies_match_a_numpy_power_loop():
    """The SpMV bench's solve: 8 applies on the PR layout with scale 0.2,
    each normalized by max|y|, equal (1e-5) to the same loop in numpy
    over the relabelled graph's CSR, and through the plain K1 on the
    CPU (no launch counted)."""
    from gardenia_tpu_torch.bench import SPMV_REPS, spmv_applies
    from gardenia_tpu_torch.core.generate import generate_graph as tgen
    g = tgen("rmat", scale=12, degree=16, symmetrize=True)
    before = dict(tpanel.LAUNCHES)
    got = spmv_applies(g, torch.device("cpu")).numpy()
    assert tpanel.LAUNCHES == before
    g2, hyb, _ = views.relabeled_hybrid(g, "cpu")
    assert hyb.dense and hyb.scale == 1.0       # the PR layout stays as is
    x = np.full(g2.n, 0.3)
    src = np.repeat(np.arange(g2.m), np.diff(g2.rowptr))
    for _ in range(SPMV_REPS):
        y = np.zeros(g2.m)
        np.add.at(y, src, 0.2 * x[g2.colidx])
        x = y / np.abs(y).max()
    assert np.abs(got - x).max() <= 1e-5
