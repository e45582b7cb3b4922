"""The port's pull PageRank (gardenia_tpu_torch.solvers.pr) against the JAX
solver on the same R-MAT graphs, both on the CPU.  The JAX side is asked
for layout="hybrid" explicitly: its "auto" resolves to "ell" off the TPU."""

import numpy as np
import pytest
import torch

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.solvers import pr as jpr
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.ops import panel as tpanel
from gardenia_tpu_torch.solvers import pr as tpr


def _rmat(scale):
    return generate_graph("rmat", scale=scale, degree=16, symmetrize=True,
                          need_reverse=True)


@pytest.mark.parametrize("scale", [12, 14])
def test_pr_hybrid_matches_jax(scale):
    g = _rmat(scale)
    res_t = tpr.pr_solver(from_csr_of(g), layout="hybrid", device="cpu")
    res_j = jpr.pr_solver(g, layout="hybrid")
    it = int(res_j.iterations)
    assert res_t.iterations == it
    s_t = res_t.scores.numpy()
    assert s_t.shape == (g.m,) and s_t.dtype == np.float32
    assert np.abs(s_t - np.asarray(res_j.scores)).sum() < 1e-5
    e_t, e_j = res_t.errors.numpy(), np.asarray(res_j.errors)
    np.testing.assert_allclose(e_t[:it], e_j[:it], rtol=2e-3)
    assert np.isinf(e_t[it:]).all() and len(e_t) == tpr.MAX_ITER
    assert oracles.pagerank_push_residual(g, s_t) < tpr.EPSILON
    assert tpanel.LAUNCHES == 0          # CPU tensors: plain version only


def test_pr_ell_layout_matches_hybrid():
    g = from_csr_of(_rmat(12))
    res_h = tpr.pr_solver(g, layout="hybrid", device="cpu")
    res_e = tpr.pr_solver(g, layout="ell", device="cpu")
    res_a = tpr.pr_solver(g, device="cpu")
    assert res_e.iterations == res_h.iterations == res_a.iterations
    assert (res_e.scores - res_h.scores).abs().sum() < 1e-5


def test_pr_directed_graph_matches_serial_oracle():
    """A directed graph: the pull sweep reads the reverse CSR, and
    vertices without out-edges contribute nothing."""
    g = generate_graph("rmat", scale=10, degree=8, symmetrize=False,
                       need_reverse=True)
    res = tpr.pr_solver(from_csr_of(g), device="cpu")
    expect, iters, _ = oracles.pagerank_serial(g)
    assert res.iterations == iters
    assert np.abs(res.scores.numpy() - expect).sum() < 1e-4


def test_pr_print_trace_matches_jax(capsys):
    errs = np.full(tpr.MAX_ITER, np.inf, np.float32)
    errs[:4] = [0.97, 0.25, 1.5e-3, 9.9e-5]
    jpr.pr_print_trace(jpr.PRResult(None, np.int32(4), errs))
    want = capsys.readouterr().out
    tpr.pr_print_trace(tpr.PRResult(None, 4, torch.from_numpy(errs)))
    assert capsys.readouterr().out == want
    assert want.endswith("\titerations = 4.\n")


@pytest.mark.parametrize("variant", ["push", "delta"])
def test_pr_unported_variants_raise(variant):
    with pytest.raises(NotImplementedError, match="A3"):
        tpr.pr_solver(from_csr_of(_rmat(8)), variant=variant, device="cpu")
