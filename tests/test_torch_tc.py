"""The port's triangle counting (gardenia_tpu_torch.solvers.tc and
ops/tc_count, ops/intersect) against the JAX package on the same inputs,
both on the CPU: the host prep array by array, each kernel's plain
version against the Pallas kernel in interpret mode (or the XLA pass),
and the solvers' counts against JAX's and the serial oracle's, all
exact.  Inputs come from numpy seeds."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.core.graph import Graph
from gardenia_tpu.core.relabel import relabeled as jrelabeled
from gardenia_tpu.solvers import tc as jtc
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch.core.graph import Graph as TGraph, from_csr_of
from gardenia_tpu_torch.ops import intersect as tint
from gardenia_tpu_torch.ops import tc_count
from gardenia_tpu_torch.solvers import tc as ttc

GRAPHS = {
    "rand": lambda: random_graph(m=400, avg_deg=30, seed=6, symmetric=True),
    "rmat10": lambda: generate_graph("rmat", scale=10, symmetrize=True),
    "rmat12": lambda: generate_graph("rmat", scale=12, symmetrize=True),
}


@functools.lru_cache(maxsize=None)
def _expected(name):
    """(JAX tc_solver's count, the serial oracle's) on a fresh graph."""
    g = GRAPHS[name]()
    return jtc.tc_solver(g), oracles.tc_serial(g.oriented())


def _sorted_rows(rng, fills, universe=4000):
    """(len(fills), 128) int32 rows of distinct ascending ids, -1 pads."""
    rows = np.full((len(fills), 128), -1, np.int32)
    for r, f in enumerate(fills):
        rows[r, :f] = np.sort(rng.choice(universe, f, replace=False))
    return rows


def _overlapping_rows(rng, fills_a, fills_b):
    """Row pairs as test_bitonic_merge_intersect_oracle builds them: b
    takes half its ids from a, so the pairs overlap."""
    rows_a, rows_b = [], []
    for fa, fb in zip(fills_a, fills_b):
        a = np.sort(rng.choice(4000, fa, replace=False)) if fa else \
            np.zeros(0, np.int64)
        b = np.sort(np.unique(np.concatenate(
            [rng.choice(4000, max(fb - fb // 2, 0), replace=False),
             rng.choice(a, min(fb // 2, len(a)), replace=False) if fa
             else np.zeros(0, np.int64)])))[:fb]
        ra = np.full(128, -1, np.int32)
        rb = np.full(128, -1, np.int32)
        ra[:len(a)] = a
        rb[:len(b)] = b
        rows_a.append(ra)
        rows_b.append(rb)
    return np.stack(rows_a), np.stack(rows_b)


def _intersections(table, cu, cv):
    return np.array([len(np.intersect1d(table[u][table[u] >= 0],
                                        table[v][table[v] >= 0]))
                     for u, v in zip(cu, cv)])


@pytest.mark.parametrize("case", ["rmat12", "rand", "no_bitmap"])
def test_prep_matches_jax(case, monkeypatch):
    """tc_prep equals the reference's prep (read from its per-graph cache
    after a JAX solve) array by array, with HUB_THRESHOLD lowered so the
    hub bitmap is built."""
    monkeypatch.setattr(jtc, "HUB_THRESHOLD", 32)
    monkeypatch.setattr(ttc, "HUB_THRESHOLD", 32)
    use_bitmap = case != "no_bitmap"
    g = GRAPHS["rand" if case == "rand" else "rmat12"]()
    jcount = jtc.tc_rotate(g, use_bitmap=use_bitmap)
    # the DAG object the JAX solve cached its prep on
    jdag = jrelabeled(g).graph._dev(("oriented",), None)
    jth, jstreams, jbm, jsent = jdag._device_cache[
        ("tc_rot3_prep", use_bitmap)][0]
    tg = from_csr_of(g)
    dag = ttc.tc_dag(tg)
    np.testing.assert_array_equal(dag.rowptr, jdag.rowptr)
    np.testing.assert_array_equal(dag.colidx, jdag.colidx)
    th, streams, bm, sent = ttc.tc_prep(dag, use_bitmap)
    assert th.dtype == jth.dtype and sent == jsent == len(th) - 1
    np.testing.assert_array_equal(th, jth)
    assert sorted(streams) == sorted(jstreams) and len(streams) >= 3
    for W in streams:
        for a, b in zip(streams[W], jstreams[W]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (bm is None) == (jbm is None) == (not use_bitmap)
    if use_bitmap:
        assert len(bm[1]) > 0
        for a, b in zip(bm, jbm):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert ttc.tc_rotate(tg, use_bitmap=use_bitmap, device="cpu") == jcount


@pytest.mark.parametrize("W", ttc.ROT_WIDTHS)
def test_rot_count_plain_matches_pallas(W):
    """rot_count on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode on the operands _make_rot_run builds, and
    against np.intersect1d pair by pair."""
    rng = np.random.default_rng(W)
    P = 64
    fills_u = rng.integers(0, W + 1, P)
    fills_v = rng.integers(0, 129, P)
    table = np.concatenate([_sorted_rows(rng, fills_u, 300),
                            _sorted_rows(rng, fills_v, 300)])
    cu = np.arange(P, dtype=np.int32)
    cv = cu + P
    got = tc_count.rot_count(torch.from_numpy(table), torch.from_numpy(cu),
                             torch.from_numpy(cv), W, chunk=24).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _intersections(table, cu, cv))
    A = table[cu]
    A = np.tile(A[:, :W], (1, 128 // W)) if W < 128 else A
    B = np.where(table[cv] == -1, -2, table[cv])
    with pltpu.force_tpu_interpret_mode():
        want = int(jtc._rot_count_pallas(jnp.asarray(A), jnp.asarray(B), W,
                                         interpret=True).sum())
    assert int(got.sum()) == want


@pytest.mark.parametrize("W", ttc.ROT_WIDTHS)
def test_rot_count_plain_matches_merge_and_numpy(W):
    """K3's and K4's plain versions and a numpy set intersection agree
    pair by pair on seeded streams in (cv, cu) order and shuffled, with
    the all-pad sentinel row on either side of some pairs."""
    rng = np.random.default_rng(200 + W)
    P = 80
    table = np.concatenate([
        _sorted_rows(rng, rng.integers(0, W + 1, P), 300),     # cu's rows
        _sorted_rows(rng, rng.integers(0, 129, P), 300),       # cv's rows
        np.full((1, 128), -1, np.int32)])                      # the sentinel
    sent = 2 * P
    n = 333
    cu = rng.integers(0, P, n)
    cv = rng.integers(P, 2 * P, n)
    cu[rng.random(n) < 0.1] = sent
    cv[rng.random(n) < 0.1] = sent
    cu[:2], cv[:2] = (sent, 0), (P, sent)
    order = np.lexsort((cu, cv))
    want = _intersections(table, cu, cv)
    assert want.max() > 0 and (want[(cu == sent) | (cv == sent)] == 0).all()
    t = torch.from_numpy(table)
    for idx in (order, rng.permutation(n)):
        u = torch.from_numpy(cu[idx].astype(np.int32))
        v = torch.from_numpy(cv[idx].astype(np.int32))
        rot = tc_count.rot_count(t, u, v, W, chunk=50)
        assert rot.dtype == torch.int32
        np.testing.assert_array_equal(rot.numpy(), want[idx])
        np.testing.assert_array_equal(
            tc_count.merge_count(t, u, v, W, chunk=70).numpy(), want[idx])


def test_rot_count_rejects_width():
    table = torch.full((2, 128), -1, dtype=torch.int32)
    idx = torch.zeros(1, dtype=torch.int32)
    for W in (0, 4, 12, 100, 256):
        with pytest.raises(ValueError, match="W="):
            tc_count.rot_count(table, idx, idx, W)
    for W in ttc.ROT_WIDTHS:
        assert tc_count.rot_count(table, idx, idx, W).tolist() == [0]


def test_merge_count_plain_matches_pallas():
    """merge_count's plain version against the Pallas merge kernel in
    interpret mode and _bitonic_intersect, row by row, for the fill cases
    of test_bitonic_merge_intersect_oracle."""
    import jax

    rng = np.random.default_rng(3)
    fills = [(0, 0), (0, 128), (128, 128), (1, 1), (7, 100), (64, 64),
             (128, 1), (100, 100), (33, 97), (128, 0), (5, 5), (2, 120),
             (90, 30), (127, 127), (16, 17), (50, 3)]
    ra, rb = _overlapping_rows(rng, *zip(*fills))
    P = len(fills)
    table = np.concatenate([ra, rb])
    cu = np.arange(P, dtype=np.int32)
    cv = cu + P
    got = tc_count.merge_count(torch.from_numpy(table), torch.from_numpy(cu),
                               torch.from_numpy(cv), chunk=5).numpy()
    expect = _intersections(table, cu, cv)
    np.testing.assert_array_equal(got, expect)
    assert expect.sum() > 0
    brev = rb[:, ::-1].copy()
    lane = jax.lax.broadcasted_iota(jnp.int32, ra.shape, 1)
    eq = jtc._bitonic_intersect(jnp.asarray(ra), jnp.asarray(brev),
                                lambda x, s: jnp.roll(x, s, axis=1), lane)
    np.testing.assert_array_equal(got, np.asarray(eq.sum(axis=1)))
    # 8 rows per call: the kernel's (8, Tt/8, 128) partials are then rows
    with pltpu.force_tpu_interpret_mode():
        for lo in range(0, P, 8):
            part = jtc._merge_count_pallas(jnp.asarray(ra[lo:lo + 8]),
                                           jnp.asarray(brev[lo:lo + 8]),
                                           interpret=True)
            np.testing.assert_array_equal(np.asarray(part).sum(axis=1),
                                          got[lo:lo + 8])


@pytest.mark.parametrize("W", ttc.ROT_WIDTHS)
def test_merge_count_width_prefix(W):
    """merge_count(..., W) counts |set(a[:W]) & set(b)| pair by pair, and
    equals W = 128 wherever cu's fill is at most W."""
    rng = np.random.default_rng(100 + W)
    P = 96
    ra, rb = _overlapping_rows(rng, rng.integers(0, 129, P),
                               rng.integers(0, 129, P))
    table = torch.from_numpy(np.concatenate([ra, rb]))
    cu = torch.arange(P, dtype=torch.int32)
    cv = cu + P
    got = tc_count.merge_count(table, cu, cv, W, chunk=17).numpy()
    assert got.dtype == np.int32
    want = [len(np.intersect1d(a[:W][a[:W] >= 0], b[b >= 0]))
            for a, b in zip(ra, rb)]
    np.testing.assert_array_equal(got, want)
    full = tc_count.merge_count(table, cu, cv).numpy()
    fits = (ra >= 0).sum(axis=1) <= W
    assert fits.any() and (W == 128 or not fits.all())
    np.testing.assert_array_equal(got[fits], full[fits])


def test_merge_count_rejects_width():
    table = torch.full((2, 128), -1, dtype=torch.int32)
    idx = torch.zeros(1, dtype=torch.int32)
    for W in (0, 4, 12, 100, 256):
        with pytest.raises(ValueError, match="W="):
            tc_count.merge_count(table, idx, idx, W)
    for W in ttc.ROT_WIDTHS:
        assert tc_count.merge_count(table, idx, idx, W).tolist() == [0]


@pytest.mark.parametrize("case", ["rmat12", "rand"])
def test_tc_data_orders_classes_by_shared_row(case, monkeypatch):
    """tc_data's class streams are tc_prep's, permuted into (cv, cu)
    order; the hub stream is tc_prep's as it stands."""
    monkeypatch.setattr(ttc, "HUB_THRESHOLD", 32)
    dag = ttc.tc_dag(from_csr_of(GRAPHS[case]()))
    _, streams, bm, _ = ttc.tc_prep(dag, True)
    data = ttc.tc_data(dag, True, "cpu")
    assert sorted(data.streams) == sorted(streams) and len(streams) >= 3
    for W, (cu, cv) in streams.items():
        tcu, tcv = (t.numpy() for t in data.streams[W])
        assert tcu.dtype == tcv.dtype == np.int32
        key = tcv.astype(np.int64) << 32 | tcu
        assert (np.diff(key) > 0).all()          # sorted by (cv, cu)
        want = np.sort(cv.astype(np.int64) << 32 | cu)
        np.testing.assert_array_equal(key, want)  # the same multiset
    assert bm is not None and data.bitmap is not None
    np.testing.assert_array_equal(data.bitmap[1].numpy(), bm[1])
    np.testing.assert_array_equal(data.bitmap[2].numpy(), bm[2])
    np.testing.assert_array_equal(data.bitmap[0].numpy(),
                                  bm[0].view(np.int32))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tc_rotate_any_stream_order(name):
    """The rotate path counts what the JAX package's tc_rotate counts on
    a seeded shuffle of every uploaded stream, hub pairs included."""
    g = from_csr_of(GRAPHS[name]())
    dag = ttc.tc_dag(g)
    data = ttc.tc_data(dag, True, "cpu")
    gen = torch.Generator().manual_seed(11)
    for W, (cu, cv) in list(data.streams.items()):
        perm = torch.randperm(len(cu), generator=gen)
        assert len(cu) < 3 or not torch.equal(perm, torch.arange(len(cu)))
        data.streams[W] = (cu[perm].contiguous(), cv[perm].contiguous())
    if data.bitmap is not None:
        bmp, hu, hv = data.bitmap
        perm = torch.randperm(len(hu), generator=gen)
        data.bitmap = (bmp, hu[perm].contiguous(), hv[perm].contiguous())
    assert ttc.tc_data(dag, True, "cpu") is data    # the solve reads these
    got = ttc.tc_rotate(g, device="cpu")
    assert got == jtc.tc_rotate(GRAPHS[name]()) == _expected(name)[1]


def test_merge_count_plain_keeps_pad_key_limit():
    table = torch.full((2, 128), -1, dtype=torch.int32)
    table[0, 0] = 1 << 28
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^28"):
        tc_count.merge_count(table, idx, idx)


@pytest.mark.parametrize("wpad", [4, 256])
def test_bitmap_count_plain_matches_numpy(wpad):
    rng = np.random.default_rng(wpad)
    bmp = rng.integers(0, 2 ** 32, (41, wpad), dtype=np.uint64) \
        .astype(np.uint32)
    bmp[5] = 0xFFFFFFFF                   # every sign bit set
    bmp[-1] = 0                           # the zero sentinel row
    hu = rng.integers(0, 41, 300).astype(np.int32)
    hv = rng.integers(0, 41, 300).astype(np.int32)
    hu[:3] = [5, 5, 40]
    hv[:3] = [5, 7, 5]
    got = tc_count.bitmap_count(torch.from_numpy(bmp.view(np.int32)),
                                torch.from_numpy(hu), torch.from_numpy(hv),
                                chunk=7).numpy()
    want = np.bitwise_count(bmp[hu] & bmp[hv]).sum(axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.unpackbits((bmp[hu] & bmp[hv]).view(np.uint8), axis=1)
        .sum(axis=1))
    assert got[0] == 32 * wpad and got[2] == 0


CONDITIONS = ["default", "merge8", "merge16", "merge32", "merge64",
              "merge128", "merge256", "hub16", "no_bitmap", "no_relabel",
              "bsearch"]


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("cond", CONDITIONS)
def test_tc_solver_matches_jax_and_oracle(name, cond, monkeypatch):
    """Every route of the port counts what JAX's tc_solver and the serial
    oracle count: the port's own K3/K4 crossover (default), all classes
    through K3's plain version (merge256) or K4's (merge8) and every
    crossover between, more hub pairs through H1's (hub16), none
    (no_bitmap), natural ids (no_relabel), and the bsearch variant."""
    kw = {}
    if cond.startswith("merge"):
        monkeypatch.setattr(ttc, "MERGE_MIN_W", int(cond[5:]))
    elif cond == "hub16":
        monkeypatch.setattr(ttc, "HUB_THRESHOLD", 16)
    elif cond == "no_bitmap":
        kw = {"use_bitmap": False}
    elif cond == "no_relabel":
        kw = {"use_relabel": False}
    elif cond == "bsearch":
        kw = {"variant": "bsearch", "chunk": 5000}
    g = from_csr_of(GRAPHS[name]())
    before = dict(tc_count.LAUNCHES)
    got = ttc.tc_solver(g, device="cpu", **kw)
    jax_count, oracle = _expected(name)
    assert got == jax_count == oracle > 0
    assert tc_count.LAUNCHES == before   # CPU tensors: plain versions only
    if cond == "hub16":
        dag = ttc.tc_dag(g)
        assert ttc.tc_data(dag, True, "cpu").bitmap is not None


def test_tc_empty_dag():
    g = TGraph(np.zeros(9, np.int64), np.zeros(0, np.int32), num_cols=8,
              symmetric=True)
    assert jtc.tc_solver(Graph(g.rowptr, g.colidx, num_cols=8,
                               symmetric=True)) == 0
    for variant in ("rotate", "bsearch"):
        assert ttc.tc_solver(g, variant=variant, device="cpu") == 0
    with pytest.raises(ValueError):
        ttc.tc_solver(g, variant="nope", device="cpu")


def test_tc_pair_count_not_multiple_of_8():
    """Class streams of any length are counted whole, in steps of any
    size: the reference's Pallas kernels count only nsub * 1024 of P rows
    (tc.py:205-207, 307-309) — shown here on its rotation kernel — and
    the port does not copy that."""
    g = random_graph(m=300, avg_deg=14, seed=8, symmetric=True)
    tg = from_csr_of(g)
    dag = ttc.tc_dag(tg)
    data = ttc.tc_data(dag, True, "cpu")
    lens = [len(cu) for cu, _ in data.streams.values()]
    assert any(n % 8 for n in lens) and any(n > 1024 for n in lens)
    expect = oracles.tc_serial(g.oriented())
    assert jtc.tc_solver(g, chunk=1500) == expect
    for chunk in (1500, 3, 1 << 20):
        assert ttc.tc_rotate(tg, chunk=chunk, device="cpu") == expect
    for chunk in (1500, 97, 1 << 20):
        assert ttc.tc_bsearch(tg, chunk=chunk, device="cpu") == expect
    W = 8 if 8 in data.streams else min(data.streams)
    cu, cv = data.streams[W]
    rows = 1032
    idx = torch.arange(rows) % len(cu)
    cu, cv = cu[idx].contiguous(), cv[idx].contiguous()
    port = tc_count.rot_count(data.table, cu, cv, W)
    A = data.table[cu].numpy()
    A = np.tile(A[:, :W], (1, 128 // W))
    B = data.table[cv].numpy()
    B = np.where(B == -1, -2, B)
    with pltpu.force_tpu_interpret_mode():
        ref = int(jtc._rot_count_pallas(jnp.asarray(A), jnp.asarray(B), W,
                                        interpret=True).sum())
    assert ref == int(port[:1024].sum()) < int(port.sum())


def test_wrappers_check_inputs():
    """Wrong dtype, shape or device raises before anything runs; CPU
    tensors take the plain versions and count no launch."""
    table = torch.full((4, 128), -1, dtype=torch.int32)
    table[:, :3] = torch.tensor([1, 2, 3], dtype=torch.int32)
    idx = torch.tensor([0, 1, 3], dtype=torch.int32)
    bmp = torch.zeros((3, 8), dtype=torch.int32)
    hidx = torch.tensor([0, 2], dtype=torch.int32)
    before = dict(tc_count.LAUNCHES)
    assert tc_count.rot_count(table, idx, idx, 8).tolist() == [3, 3, 3]
    assert tc_count.merge_count(table, idx, idx).tolist() == [3, 3, 3]
    assert tc_count.bitmap_count(bmp, hidx, hidx).tolist() == [0, 0]
    assert tc_count.LAUNCHES == before
    with pytest.raises(TypeError):
        tc_count.rot_count(table.long(), idx, idx, 8)
    with pytest.raises(TypeError):
        tc_count.merge_count(table, idx.long(), idx)
    with pytest.raises(TypeError):
        tc_count.bitmap_count(bmp, hidx, hidx.long())
    with pytest.raises(ValueError):
        tc_count.rot_count(table[:, :64], idx, idx, 8)
    with pytest.raises(ValueError):
        tc_count.rot_count(table, idx, idx, 12)
    with pytest.raises(ValueError):
        tc_count.merge_count(table, idx, idx[:2])
    with pytest.raises(ValueError):
        tc_count.bitmap_count(bmp[:, :6], hidx, hidx)
    with pytest.raises(ValueError):
        tc_count.merge_count(table, idx.to("meta"), idx)
    with pytest.raises(ValueError):
        tc_count.merge_count(table.to("meta"), idx.to("meta"),
                             idx.to("meta"))


def test_membership_counts():
    g = random_graph(m=50, avg_deg=6, seed=1, symmetric=True)
    rp = torch.from_numpy(g.rowptr.astype(np.int64))
    ci = torch.from_numpy(g.colidx)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, g.m, 500)
    q = rng.integers(0, g.m, 500).astype(np.int32)
    expect = sum(int(q[i] in set(g.colidx[g.rowptr[r]:g.rowptr[r + 1]]))
                 for i, r in enumerate(rows))
    got = tint.membership_counts(rp, ci, torch.from_numpy(q),
                                 torch.from_numpy(rows), search_rounds=8)
    assert got.dtype == torch.int64 and 0 < int(got) == expect < len(q)
