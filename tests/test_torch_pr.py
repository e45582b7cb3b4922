"""The port's PageRank (gardenia_tpu_torch.solvers.pr: pull, push and
delta) against the JAX solver on the same R-MAT graphs, both on the CPU.
The JAX side is asked for layout="hybrid" explicitly: its "auto" resolves
to "ell" off the TPU."""

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


# the layouts held to the JAX solver's hybrid: the port's hybrid, and its
# ELL layout over the same relabelled ids that "auto" takes on a card (the
# same sums in another order); the hybrid cases keep their ids
_PULL_CASES = [pytest.param(12, "hybrid", id="12"),
               pytest.param(14, "hybrid", id="14"),
               pytest.param(12, "ell", id="12-ell"),
               pytest.param(14, "ell", id="14-ell")]


@pytest.mark.parametrize("scale,layout", _PULL_CASES)
def test_pr_hybrid_matches_jax(scale, layout):
    g = _rmat(scale)
    res_t = tpr.pr_solver(from_csr_of(g), layout=layout, device="cpu")
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
    assert not any(tpanel.LAUNCHES.values())     # on the CPU: plain only


def test_pr_ell_layout_matches_hybrid():
    g = from_csr_of(_rmat(12))
    res_h = tpr.pr_solver(g, layout="hybrid", device="cpu")
    res_e = tpr.pr_solver(g, layout="ell", device="cpu")
    res_a = tpr.pr_solver(g, device="cpu")
    assert res_e.iterations == res_h.iterations == res_a.iterations
    assert (res_e.scores - res_h.scores).abs().sum() < 1e-5


def test_pr_auto_layout_by_device():
    """"auto" is the ELL layout where E1 runs the apply (a CUDA device)
    and the hybrid layout elsewhere; a named layout is itself."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tpr.resolve_layout("auto", cuda) == "ell"
    assert tpr.resolve_layout("auto", torch.device("cuda", 1)) == "ell"
    assert tpr.resolve_layout("auto", cpu) == "hybrid"
    for name in ("hybrid", "ell"):
        assert tpr.resolve_layout(name, cuda) == name
        assert tpr.resolve_layout(name, cpu) == name


@pytest.mark.parametrize("variant", ["pull", "delta"])
def test_pr_counts_the_layout_it_runs(variant):
    """One pr.layout.<name> count a solve, under the resolved name."""
    from gardenia_tpu_torch.utils import profiler
    g = from_csr_of(_rmat(8))
    profiler.take()
    with profiler.recording():
        for layout in ("auto", "hybrid", "ell", "ell"):
            tpr.pr_solver(g, variant=variant, layout=layout, device="cpu")
    got = {k: v for k, v in profiler.take()["counters"].items()
           if k.startswith("pr.layout.")}
    assert got == {"pr.layout.hybrid": 2, "pr.layout.ell": 2}


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
    """push and delta were unported once and raised NotImplementedError;
    they run now, and only an unknown variant or layout raises."""
    g = from_csr_of(_rmat(8))
    res = tpr.pr_solver(g, variant=variant, device="cpu")
    assert 0 < res.iterations < tpr.MAX_ITER
    assert torch.isfinite(res.scores).all() and float(res.scores.min()) > 0
    with pytest.raises(ValueError, match="variant"):
        tpr.pr_solver(g, variant=variant + "x", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        tpr.pr_solver(g, variant="delta", layout="csr", device="cpu")


def _directed(scale):
    return generate_graph("rmat", scale=scale, degree=8, symmetrize=False,
                          need_reverse=True)


# the JAX package's ELL layout keeps the generator's ids, and its hybrid is
# relabelled: the port's relabelled ell is held to both
@pytest.mark.parametrize("variant,layout,kind,jax_layout", [
    pytest.param("push", "auto", "rmat12", "auto", id="push-auto-rmat12"),
    pytest.param("push", "auto", "directed10", "auto",
                 id="push-auto-directed10"),
    pytest.param("delta", "hybrid", "rmat12", "hybrid",
                 id="delta-hybrid-rmat12"),
    pytest.param("delta", "ell", "rmat12", "ell", id="delta-ell-rmat12"),
    pytest.param("delta", "hybrid", "directed10", "hybrid",
                 id="delta-hybrid-directed10"),
    pytest.param("delta", "ell", "directed10", "ell",
                 id="delta-ell-directed10"),
    pytest.param("delta", "ell", "rmat12", "hybrid",
                 id="delta-ell-rmat12-hybrid"),
    pytest.param("delta", "ell", "directed10", "hybrid",
                 id="delta-ell-directed10-hybrid")])
def test_pr_push_and_delta_match_jax(variant, layout, kind, jax_layout):
    """Iteration count equal; scores within verify/compare's tolerance
    (maximum_relative_error below sqrt(f32 eps), the SpMV check of both
    CLIs) and within 1e-5 in L1; the error trace within 1e-5 relative
    plus 1e-7 absolute (the same f32 formula with its sums in another
    order: a late error is an L1 sum of differences of nearly equal f32
    scores, which carries ~1e-8 of noise whatever its size).  Delta's
    trace gets 1e-4 relative: a vertex whose |delta| sits at the activity
    threshold EPSILON2 * score falls on either side of it by rounding."""
    from gardenia_tpu_torch.verify import maximum_relative_error
    g = _rmat(12) if kind == "rmat12" else _directed(10)
    res_t = tpr.pr_solver(from_csr_of(g), variant=variant, layout=layout,
                          device="cpu")
    res_j = jpr.pr_solver(g, variant=variant, layout=jax_layout)
    it = int(res_j.iterations)
    assert res_t.iterations == it and 0 < it < tpr.MAX_ITER
    s_t, s_j = res_t.scores.numpy(), np.asarray(res_j.scores)
    assert s_t.shape == (g.m,) and s_t.dtype == np.float32
    assert maximum_relative_error(s_t, s_j) < np.sqrt(np.finfo(np.float32).eps)
    assert np.abs(s_t - s_j).sum() < 1e-5
    e_t, e_j = res_t.errors.numpy(), np.asarray(res_j.errors)
    np.testing.assert_allclose(e_t[:it], e_j[:it], atol=1e-7,
                               rtol=1e-4 if variant == "delta" else 1e-5)
    assert np.isinf(e_t[it:]).all()
    if variant == "push":
        assert oracles.pagerank_push_residual(g, s_t) < tpr.EPSILON


def test_pr_push_equals_pull_and_delta_is_near():
    """Push sums the same products as pull in another order: same
    iterations, scores within 1e-5 in L1.  Delta stops propagating small
    residuals (EPSILON2), so it only comes near: 1e-3 in L1."""
    g = from_csr_of(_rmat(12))
    pull = tpr.pr_solver(g, layout="ell", device="cpu")
    push = tpr.pr_solver(g, variant="push", device="cpu")
    delta = tpr.pr_solver(g, variant="delta", device="cpu")
    assert push.iterations == pull.iterations
    assert (push.scores - pull.scores).abs().sum() < 1e-5
    assert (delta.scores - pull.scores).abs().sum() < 1e-3
    assert tpr.EPSILON2 == jpr.EPSILON2
