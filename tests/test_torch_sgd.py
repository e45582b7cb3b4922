"""The port's matrix-factorisation SGD (gardenia_tpu_torch.solvers.sgd) and
its checkpointer (gardenia_tpu_torch.utils.checkpoint) against the JAX
package's on the same numpy-seeded rating graphs and latent tables, on
the CPU.  Tolerances: the RMSE trace within 1e-5 relative and the factors
within rtol 1e-4, atol 1e-6 — the same f32 arithmetic, summed in another
order (index_add_ against segment_sum; measured ~1e-7 and ~3e-6).  The
epoch count of an early stop is equal.  A resumed checkpointed run
equals an unbroken one, and each package restores the other's
checkpoints."""

import collections

import numpy as np
import pytest
import torch

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.core.graph import Graph
from gardenia_tpu.solvers import sgd as jsgd
from gardenia_tpu.utils.checkpoint import Checkpointer as JCheckpointer

from gardenia_tpu_torch.cli import sgd_trace_ok
from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.solvers import sgd
from gardenia_tpu_torch.utils import checkpoint
from gardenia_tpu_torch.utils.checkpoint import Checkpointer


def rated(g, seed=13) -> Graph:
    rng = np.random.default_rng(seed)
    return Graph(g.rowptr, g.colidx,
                 rng.integers(1, 6, g.nnz).astype(np.float64),
                 num_cols=g.n, symmetric=g.symmetric)


GRAPHS = {
    "rmat10": lambda: rated(generate_graph("rmat", scale=10,
                                           symmetrize=True)),
    "bipartite": lambda: rated(random_graph(m=120, avg_deg=6, seed=4)),
    "unrated": lambda: random_graph(m=100, avg_deg=5, seed=9),
}


def assert_close(got, want, iters=None):
    trace, ref = got.rmse.numpy(), np.asarray(want.rmse)
    assert got.iterations == int(want.iterations)
    n = got.iterations if iters is None else iters
    np.testing.assert_allclose(trace[:n], ref[:n], rtol=1e-5)
    assert np.isinf(trace[n:]).all() and np.isinf(ref[n:]).all()
    for a, b in ((got.user_lv, want.user_lv), (got.item_lv, want.item_lv)):
        assert a.dtype == torch.float32 and a.shape[1] == sgd.K
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("batches,step", [(4, 0.1), (1, 0.05), (0, 0.003)])
def test_sgd_matches_jax(graph, batches, step):
    g = GRAPHS[graph]()
    kw = dict(step=step, max_iters=4, epsilon=0.0, batches=batches)
    want = jsgd.sgd_solver(g, **kw, **({"packed": False} if batches
                                       else {}))
    got = sgd.sgd_solver(from_csr_of(g), **kw, device="cpu")
    assert_close(got, want)


def test_sgd_minibatch_trace_descends():
    g = GRAPHS["rmat10"]()
    got = sgd.sgd_solver(from_csr_of(g), step=0.1, max_iters=6,
                         epsilon=0.0, batches=4, device="cpu")
    assert sgd_trace_ok(got.rmse.numpy()[:got.iterations])


@pytest.mark.parametrize("epsilon", [1.45, 1.42, 0.5])
def test_sgd_early_stop_matches_jax(epsilon):
    g = GRAPHS["rmat10"]()
    kw = dict(step=0.1, max_iters=10, epsilon=epsilon, batches=4)
    want = jsgd.sgd_solver(g, packed=False, **kw)
    got = sgd.sgd_solver(from_csr_of(g), **kw, device="cpu")
    assert_close(got, want)
    if epsilon > 1:
        assert got.iterations < 10


def test_sgd_init_is_copied_not_updated():
    g = from_csr_of(GRAPHS["bipartite"]())
    init = (torch.from_numpy(sgd.init_latent(g.m, 0)),
            torch.from_numpy(sgd.init_latent(sgd.num_items(g), 1)))
    before = [t.clone() for t in init]
    a = sgd.sgd_solver(g, step=0.1, max_iters=2, epsilon=0.0, batches=2,
                       init=init, device="cpu")
    b = sgd.sgd_solver(g, step=0.1, max_iters=2, epsilon=0.0, batches=2,
                       device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(init, before))
    assert torch.equal(a.user_lv, b.user_lv)


def test_sgd_epoch_data_matches_jax():
    """The static shuffle, pads and inverse batch counts equal the JAX
    package's exactly."""
    g = GRAPHS["bipartite"]()
    src = np.repeat(np.arange(g.m, dtype=np.int32), np.diff(g.rowptr))
    r = np.asarray(g.weights, np.float32)
    n = max(g.n, int(g.colidx.max()) + 1)
    _, jdata = jsgd.make_sgd_epoch(src, g.colidx, r, 0.05, 0.1, g.m, n, 7,
                                   packed=False)
    _, data = sgd.make_sgd_epoch(src, g.colidx, r, 0.05, 0.1, g.m, n, 7,
                                 device="cpu")
    for a, b in zip(data, jdata):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --- checkpointing -------------------------------------------------------

def test_sgd_checkpointed_resume_equals_unbroken(tmp_path):
    g = from_csr_of(GRAPHS["rmat10"]())
    full = sgd.sgd_train_checkpointed(g, Checkpointer(str(tmp_path / "a")),
                                      total_iters=4, device="cpu")
    ck = Checkpointer(str(tmp_path / "b"))
    sgd.sgd_train_checkpointed(g, ck, total_iters=2, device="cpu")
    assert ck.step() == 2
    resumed = sgd.sgd_train_checkpointed(g, ck, total_iters=4,
                                         device="cpu")
    assert ck.step() == 4 and resumed.iterations == 4
    assert torch.equal(full.user_lv, resumed.user_lv)
    assert torch.equal(full.item_lv, resumed.item_lv)
    np.testing.assert_array_equal(full.rmse.numpy()[2:],
                                  resumed.rmse.numpy()[2:])


def test_sgd_checkpointed_matches_jax(tmp_path):
    g = GRAPHS["rmat10"]()
    want = jsgd.sgd_train_checkpointed(g, JCheckpointer(str(tmp_path / "j")),
                                       total_iters=3, checkpoint_every=2)
    got = sgd.sgd_train_checkpointed(from_csr_of(g),
                                     Checkpointer(str(tmp_path / "t")),
                                     total_iters=3, checkpoint_every=2,
                                     device="cpu")
    assert_close(got, want)


NT = collections.namedtuple("NT", "a b")
STATES = {
    "tuple": lambda: (np.arange(4.0), np.ones((2, 3), np.float32)),
    "nested": lambda: {"b": [np.int32(3), (np.zeros(2), None)],
                       "a": np.arange(5)},
    "namedtuple": lambda: NT(np.eye(2), [np.arange(3), np.ones(1)]),
}


@pytest.mark.parametrize("name", sorted(STATES))
def test_checkpoint_roundtrip_and_jax_layout(tmp_path, name):
    import jax
    state = STATES[name]()
    leaves, tdef = jax.tree_util.tree_flatten(state)
    assert [np.asarray(x).tolist() for x in checkpoint.flatten(state)] == \
        [np.asarray(x).tolist() for x in leaves]
    ck = Checkpointer(str(tmp_path / "s"))
    ck.save(state, step=7, note="x")
    back, step = ck.restore(like=state)
    assert step == 7 and ck.step() == 7
    assert jax.tree_util.tree_structure(back) == tdef
    for a, b in zip(checkpoint.flatten(back), leaves):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_checkpoints_cross_between_packages(tmp_path):
    u, i = torch.rand(5, 3), torch.rand(4, 3)
    like = (np.zeros((5, 3), np.float32), np.zeros((4, 3), np.float32))
    Checkpointer(str(tmp_path / "t")).save((u, i), step=3)
    (ju, ji), step = JCheckpointer(str(tmp_path / "t")).restore(like=like)
    assert step == 3
    np.testing.assert_array_equal(ju, u.numpy())
    np.testing.assert_array_equal(ji, i.numpy())
    JCheckpointer(str(tmp_path / "j")).save((u.numpy(), i.numpy()), step=5)
    (tu, ti), step = Checkpointer(str(tmp_path / "j")).restore(like=like)
    assert step == 5 and isinstance(tu, np.ndarray)
    np.testing.assert_array_equal(tu, u.numpy())
    np.testing.assert_array_equal(ti, i.numpy())


def test_checkpoint_missing_and_flat(tmp_path):
    ck = Checkpointer(str(tmp_path / "none"))
    assert ck.restore() is None and ck.step() == -1
    ck.save([np.arange(3), np.ones(2)], step=1)
    leaves, step = ck.restore()
    assert step == 1 and [x.tolist() for x in leaves] == [[0, 1, 2],
                                                          [1.0, 1.0]]
    with pytest.raises(ValueError):
        checkpoint.unflatten((1,), [1, 2])
