"""Kernel F1 (csrc/frontier_relax.cu): the sparse relax of SSSP's bucket
rounds in three launches on a card, and the route that picks it.

The CPU tests hold the route (CPU tensors take sparse_relax_plain and load
nothing of the kernel library), the launch counter as the recorder reads
it, and F1's chunk-to-owner search by a numpy copy of the kernel's index
arithmetic (`emulate_f1`), which a mocked card route also runs through
whole SSSP solves.  The tests marked `gpu` need a CUDA card and skip
without one (decided in the `card` fixture); they hold F1 to
sparse_relax_plain exactly.  This file imports no JAX, so on the card:

    python -m pytest tests/test_torch_relax_kernel.py -q --noconftest
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gardenia_tpu_torch.core.generate import generate_graph
from gardenia_tpu_torch.ops import relax as trelax
from gardenia_tpu_torch.ops.relax import (F1_CHUNK, F1_SLOTS, F1_THREADS,
                                          sparse_relax, sparse_relax_plain)
from gardenia_tpu_torch.solvers.sssp import INF, sssp_solver
from gardenia_tpu_torch.utils import profiler as P


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def _csr(degrees, seed: int = 0, max_weight: int = 255):
    """(rowptr i64, colidx i32, w i32, deg i32) of a random directed CSR
    with the given out-degrees, weights 1..max_weight."""
    rng = np.random.default_rng(seed)
    deg = np.asarray(degrees, np.int64)
    m = deg.shape[0]
    rowptr = np.zeros(m + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    nnz = int(rowptr[-1])
    colidx = rng.integers(0, max(m, 1), nnz)
    w = rng.integers(1, max_weight + 1, nnz)
    return (torch.from_numpy(rowptr), torch.from_numpy(colidx).int(),
            torch.from_numpy(w).int(), torch.from_numpy(deg).int())


def _graph_csr(g):
    """The (rowptr, colidx, w, deg) that Relaxer.of makes of a Graph."""
    w = (np.ones(g.nnz) if g.weights is None
         else np.asarray(g.weights, np.float32))
    return (torch.from_numpy(np.asarray(g.rowptr, np.int64)),
            torch.from_numpy(np.asarray(g.colidx, np.int32)),
            torch.from_numpy(w.astype(np.float32)).int(),
            torch.from_numpy(np.asarray(g.degrees, np.int32)))


def _brute(dist, active, rowptr, colidx, w):
    """new[v] = min(dist[v], dist[u] + w) over active u's out-edges, by a
    loop over the active rows in numpy int64."""
    d, rp = dist.numpy().astype(np.int64), rowptr.numpy()
    out = d.copy()
    for u in np.flatnonzero(active.numpy()):
        a, b = rp[u], rp[u + 1]
        np.minimum.at(out, colidx.numpy()[a:b],
                      d[u] + w.numpy()[a:b].astype(np.int64))
    return out


def _round(m, seed, share=0.3, near_inf=False):
    """(dist, active) of a seeded round: finite distances below 2^20 (or
    within 300 of INF), INF for a share of the vertices, which are never
    active, and a random active mask."""
    rng = np.random.default_rng(seed)
    if near_inf:
        d = rng.integers(INF - 300, INF, m)
    else:
        d = rng.integers(0, 1 << 20, m)
    unreached = rng.random(m) < 0.2
    d = np.where(unreached, INF, d)
    act = (rng.random(m) < share) & ~unreached
    return (torch.from_numpy(d.astype(np.int32)),
            torch.from_numpy(act))


def _counts(active, deg):
    return int(active.sum()), int(torch.where(active, deg, 0).sum())


# ---- a numpy copy of F1's index arithmetic --------------------------------

def find_owner(offs, lo: int, hi: int, target: int) -> int:
    """csrc/frontier_relax.cu find_owner: the last p in [lo, hi) with
    offs[p] <= target, by rounds of F1_THREADS evenly spaced probes (one a
    thread) counted as __syncthreads_count counts them."""
    while hi - lo > 1:
        step = -(-(hi - lo) // F1_THREADS)
        probe = lo + np.arange(F1_THREADS, dtype=np.int64) * step
        le = (probe < hi) & (offs[np.minimum(probe, hi - 1)] <= target)
        n = int(le.sum())
        # the probes at or below the target are a prefix of the threads
        assert n >= 1 and le[:n].all()
        lo += (n - 1) * step
        hi = min(lo + step, hi)
    return lo


def chunk_slots(offs, K: int, total: int, scout: int, chunk: int):
    """(slot, owner) of every edge slot CTA `chunk` of F1's relax takes,
    thread by thread: its first and last owner by find_owner, the staged
    offsets relative to the chunk, and each thread's binary search from
    its previous slot's owner."""
    c0 = chunk * F1_CHUNK
    c1 = min(c0 + F1_CHUNK, scout, total)
    if c0 >= c1:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    p0 = find_owner(offs, 0, K, c0)
    p1 = find_owner(offs, p0, min(p0 + F1_CHUNK, K), c1 - 1)
    P_ = p1 - p0 + 1
    assert 1 <= P_ <= F1_CHUNK
    rel = np.maximum(offs[p0:p1 + 1] - c0, 0)
    t = np.arange(F1_THREADS)
    k = np.zeros(F1_THREADS, np.int64)
    slots, owners = [], []
    for i in range(F1_SLOTS):
        l = t + i * F1_THREADS
        live = c0 + l < c1
        hi = np.full(F1_THREADS, P_)
        while True:
            go = live & (hi - k > 1)
            if not go.any():
                break
            mid = (k + hi) >> 1
            up = go & (rel[np.minimum(mid, P_ - 1)] <= l)
            k = np.where(up, mid, k)
            hi = np.where(go & ~up, mid, hi)
        slots.append(c0 + l[live])
        owners.append(p0 + k[live])
    return np.concatenate(slots), np.concatenate(owners)


def emulate_f1(dist, active, scout, rowptr, colidx, w, deg):
    """F1 in numpy: the compaction (active vertices of non-zero degree in
    order, the exclusive prefix of their degrees), every CTA's slots and
    owners, the candidates min'd into a copy of dist.  Asserts that every
    slot below the edge total is taken once."""
    d = dist.numpy()
    own = active.numpy() & (deg.numpy() > 0)
    ids = np.flatnonzero(own)
    offs = np.zeros(ids.shape[0] + 1, np.int64)
    offs[1:] = np.cumsum(deg.numpy()[ids])
    K, total = ids.shape[0], int(offs[-1])
    new = d.astype(np.int64).copy()
    seen = np.zeros(total, np.int64)
    for chunk in range(-(-scout // F1_CHUNK)):
        slot, p = chunk_slots(offs, K, total, scout, chunk)
        e = rowptr.numpy()[ids[p]] + (slot - offs[p])
        seen[slot] += 1
        np.minimum.at(new, colidx.numpy()[e],
                      d[ids[p]].astype(np.int64) + w.numpy()[e])
    n = min(scout, total)
    assert (seen[:n] == 1).all() and (seen[n:] == 0).all()
    return torch.from_numpy(new.astype(np.int32))


# ---- the route, the counter and the owner search, on the CPU --------------

@pytest.mark.parametrize("seed", [0, 1])
def test_cpu_sparse_relax_is_the_plain_version(seed, monkeypatch):
    """On the CPU the wrapper takes the plain version: the brute-force
    min, the library never loaded, no launch counted."""
    from gardenia_tpu_torch.ops import _build

    def no_library():
        raise AssertionError("the kernel library was asked for on the CPU")
    monkeypatch.setattr(_build, "lib", no_library)
    g = generate_graph("rmat", scale=10, degree=8, symmetrize=True,
                       weighted=True)
    rowptr, colidx, w, deg = _graph_csr(g)
    dist, active = _round(g.m, seed)
    before = trelax.LAUNCHES
    got = sparse_relax(dist, active, *_counts(active, deg), rowptr, colidx,
                       w, deg)
    assert got.dtype == torch.int32
    assert torch.equal(got, sparse_relax_plain(
        dist, active, *_counts(active, deg), rowptr, colidx, w, deg))
    assert np.array_equal(got.numpy(), _brute(dist, active, rowptr, colidx,
                                              w))
    assert trelax.LAUNCHES == before


def test_cpu_sssp_imports_no_kernel_code():
    """A CUDA-less SSSP solve never imports ops/_build."""
    code = (
        "import sys\n"
        "from gardenia_tpu_torch.core.generate import generate_graph\n"
        "from gardenia_tpu_torch.solvers.sssp import sssp_solver\n"
        "g = generate_graph('rmat', scale=8, degree=16, symmetrize=True,"
        " weighted=True)\n"
        "for v in ('delta', 'bf', 'hybrid'):\n"
        "    sssp_solver(g, 0, 16, variant=v, device='cpu')\n"
        "assert 'gardenia_tpu_torch.ops._build' not in sys.modules\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


def test_other_devices_raise():
    rowptr, colidx, w, deg = _csr([1, 2, 0])
    dist = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sparse_relax(dist, torch.ones(3, dtype=torch.bool), 3, 3, rowptr,
                     colidx, w, deg)


def test_launches_relax_is_read_by_the_recorder(monkeypatch):
    monkeypatch.setattr(trelax, "LAUNCHES", 7)
    P.take()
    with P.recording():
        P.count("x")
    assert P.take()["counters"]["launches.relax"] == 7


@pytest.mark.parametrize("degrees", [
    [3, 0, 5, 1, 0, 0, 7, 2],                       # ragged, zero rows
    [5000] + [1] * 40 + [0] * 9 + [3000, 2],       # hubs over chunks
    [F1_CHUNK - 1, 1, F1_CHUNK, 0, F1_CHUNK + 1],   # rows at the boundary
    [1] * (3 * F1_CHUNK + 5),                       # a chunk of owners
    [0] * 30 + [F1_CHUNK * 4] + [0] * 30,           # one hub alone
], ids=["ragged", "hubs", "boundary", "unit_rows", "lone_hub"])
@pytest.mark.parametrize("share", [1.0, 0.5])
def test_chunk_owners_match_a_brute_force_table(degrees, share):
    """find_owner and the threads' staged search give every slot of every
    chunk the owner and CSR position that a brute-force table gives."""
    rng = np.random.default_rng(len(degrees))
    rowptr, colidx, w, deg = _csr(degrees)
    active = torch.from_numpy(rng.random(len(degrees)) < share)
    own = np.flatnonzero(active.numpy() & (deg.numpy() > 0))
    d = deg.numpy()[own].astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(d)])
    total = int(offs[-1])
    table = np.repeat(np.arange(own.shape[0]), d)        # slot -> owner
    for scout in {total, max(total - 1, 0), total + F1_CHUNK}:
        got = np.full(total, -1)
        for chunk in range(-(-scout // F1_CHUNK)):
            slot, p = chunk_slots(offs, own.shape[0], total, scout, chunk)
            assert (got[slot] == -1).all()
            got[slot] = p
        n = min(scout, total)
        assert np.array_equal(got[:n], table[:n]) and (got[n:] == -1).all()
    # the CSR position of each slot
    rp, slot = rowptr.numpy(), np.arange(total)
    e = rp[own[table]] + slot - offs[table]
    want = np.concatenate([np.arange(rp[u], rp[u + 1]) for u in own]
                          ) if own.size else slot
    assert np.array_equal(e, want)


def test_find_owner_over_a_million_owners():
    offs = np.arange(0, 3 * (1 << 20) + 1, 3, dtype=np.int64)
    for target in (0, 1, 2, 3, 1234567, 3 * (1 << 20) - 1):
        assert find_owner(offs, 0, 1 << 20, target) == target // 3


@pytest.mark.parametrize("variant,delta", [("delta", 16), ("bf", 1),
                                           ("hybrid", 64)])
def test_mocked_card_route_counts_one_launch_a_sparse_round(
        variant, delta, monkeypatch):
    """With the card route forced on CPU tensors and F1's launch replaced
    by emulate_f1, the solve equals the plain route's, distances and
    rounds, and launches.relax counts one a sparse round."""
    g = generate_graph("rmat", scale=9, degree=8, symmetrize=True,
                       weighted=True)
    src = int(np.argmax(g.degrees))
    want = sssp_solver(g, src, delta, variant=variant, device="cpu")
    calls = []

    def fake_f1(dist, active, scout, rowptr, colidx, w, deg):
        calls.append(scout)
        return emulate_f1(dist, active, scout, rowptr, colidx, w, deg)
    monkeypatch.setattr(trelax, "takes_f1", lambda device: True)
    monkeypatch.setattr(trelax, "_f1", fake_f1)
    monkeypatch.setattr(trelax, "LAUNCHES", 0)
    P.take()
    with P.recording():
        got = sssp_solver(g, src, delta, variant=variant, device="cpu")
    c = P.take()["counters"]
    assert torch.equal(got.dist, want.dist)
    assert got.iterations == want.iterations
    assert c["launches.relax"] == c["sssp.rounds_sparse"] == len(calls) > 0
    assert c["sssp.edges_sparse"] == sum(calls)


# ---- F1 on the card ------------------------------------------------------

def _on(dev, *ts):
    return [t.to(dev) for t in ts]


def _hold(dev, dist, active, rowptr, colidx, w, deg):
    """F1 against the plain version on the card, exactly; returns F1's."""
    n_active, scout = _counts(active, deg)
    args = _on(dev, dist, active, rowptr, colidx, w, deg)
    before = trelax.LAUNCHES
    got = sparse_relax(args[0], args[1], n_active, scout, *args[2:])
    want = sparse_relax_plain(args[0], args[1], n_active, scout, *args[2:])
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert trelax.LAUNCHES == before + (scout > 0)
    assert torch.equal(args[0].cpu(), dist)          # dist is only read
    return got


@pytest.mark.gpu
def test_f1_library_constants_match_the_host_copy(card):
    from gardenia_tpu_torch.ops import _build
    so = _build.lib()
    assert so.gdn_frontier_relax_threads() == F1_THREADS
    assert so.gdn_frontier_relax_slots() == F1_SLOTS


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rmat16w", "kron14w"])
@pytest.mark.parametrize("share", [0.001, 0.03, 0.3])
@pytest.mark.parametrize("seed", [0, 1])
def test_f1_matches_plain_on_random_masks(card, kind, share, seed):
    if kind == "rmat16w":
        g = generate_graph("rmat", scale=16, degree=16, symmetrize=True,
                           weighted=True)
    else:
        from graphbench import generators, manifest, run
        cfg = dict(manifest.config(manifest.load_benchmark(), "kron20w"))
        cfg["scale"] = 14
        g = run.build_graph(generators.generate(cfg, 2**31 + seed, "cpu"),
                            cfg)
    rowptr, colidx, w, deg = _graph_csr(g)
    dist, active = _round(g.m, seed, share)
    _hold(card, dist, active, rowptr, colidx, w, deg)


@pytest.mark.gpu
def test_f1_star_hub_over_several_chunks(card):
    """A star: the hub's out-edges span 5 chunks and more; every leaf's
    one out-edge is a candidate for the hub (many candidates for one v)."""
    leaves = 5 * F1_CHUNK + 123
    m = leaves + 1
    src = np.concatenate([np.zeros(leaves), np.arange(1, m)])
    dst = np.concatenate([np.arange(1, m), np.zeros(leaves)])
    order = np.lexsort((dst, src))
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(src.astype(np.int64), minlength=m))]))
    colidx = torch.from_numpy(dst[order].astype(np.int32))
    w = torch.from_numpy(np.random.default_rng(2).integers(
        1, 256, 2 * leaves).astype(np.int32))
    deg = (rowptr[1:] - rowptr[:-1]).int()
    rng = np.random.default_rng(3)
    dist = torch.from_numpy(rng.integers(0, 1000, m).astype(np.int32))
    for active in (torch.arange(m) == 0, torch.arange(m) > 0,
                   torch.ones(m, dtype=torch.bool)):
        _hold(card, dist, active, rowptr, colidx, w, deg)


@pytest.mark.gpu
def test_f1_degree_zero_and_single_actives(card):
    degrees = np.random.default_rng(4).integers(0, 40, 30000)
    degrees[::7] = 0
    rowptr, colidx, w, deg = _csr(degrees, seed=4)
    m = degrees.shape[0]
    dist, _ = _round(m, 5)
    dist = torch.where(dist == INF, 7, dist)
    zero = torch.from_numpy(degrees == 0)
    # active vertices of degree 0 among others; degree 0 alone (scout 0:
    # dist itself, no launch); one active vertex; every vertex active
    mixed = zero | (torch.arange(m) % 11 == 0)
    _hold(card, dist, mixed, rowptr, colidx, w, deg)
    before = trelax.LAUNCHES
    d = dist.to(card)
    got = sparse_relax(d, zero.to(card), int(zero.sum()), 0,
                       *_on(card, rowptr, colidx, w, deg))
    assert got is d and trelax.LAUNCHES == before
    one = torch.zeros(m, dtype=torch.bool)
    one[int(np.argmax(degrees))] = True
    _hold(card, dist, one, rowptr, colidx, w, deg)
    _hold(card, dist, torch.ones(m, dtype=torch.bool), rowptr, colidx, w,
          deg)


@pytest.mark.gpu
@pytest.mark.parametrize("scout", [F1_CHUNK - 1, F1_CHUNK, F1_CHUNK + 1,
                                   3 * F1_CHUNK - 1, 3 * F1_CHUNK,
                                   3 * F1_CHUNK + 1])
@pytest.mark.parametrize("rows", ["one", "many"])
def test_f1_scout_at_chunk_boundaries(card, scout, rows):
    """The round's edge slots one below, at and one above a chunk's end:
    one row of `scout` edges, or rows of 1..9 edges summing to it."""
    if rows == "one":
        degrees = [3, scout, 5]
        pick = [1]
    else:
        rng = np.random.default_rng(scout)
        degrees, left = [], scout
        while left:
            d = min(int(rng.integers(1, 10)), left)
            degrees += [d, int(rng.integers(1, 10))]
            left -= d
        pick = list(range(0, len(degrees), 2))
    rowptr, colidx, w, deg = _csr(degrees, seed=scout)
    m = len(degrees)
    active = torch.zeros(m, dtype=torch.bool)
    active[pick] = True
    assert _counts(active, deg)[1] == scout
    dist = torch.from_numpy(np.random.default_rng(1).integers(
        0, 5000, m).astype(np.int32))
    _hold(card, dist, active, rowptr, colidx, w, deg)


@pytest.mark.gpu
def test_f1_distances_near_inf(card):
    g = generate_graph("rmat", scale=14, degree=16, symmetrize=True,
                       weighted=True)
    rowptr, colidx, w, deg = _graph_csr(g)
    dist, active = _round(g.m, 6, 0.2, near_inf=True)
    got = _hold(card, dist, active, rowptr, colidx, w, deg)
    assert int(got.max()) <= INF


@pytest.mark.gpu
def test_f1_many_tiles_and_unaligned_views(card):
    """m past the scan's 1024 tiles of 4096 (each CTA scans several), an
    m that is no multiple of 16, and views one element into their storage
    (the kernel's scalar loads)."""
    m = 1024 * 4096 * 2 + 4099
    rng = np.random.default_rng(8)
    degrees = np.zeros(m, np.int64)
    hot = rng.choice(m, 20000, replace=False)
    degrees[hot] = rng.integers(1, 30, hot.shape[0])
    rowptr, colidx, w, deg = _csr(degrees, seed=8)
    dist = torch.from_numpy(rng.integers(0, 1 << 20, m).astype(np.int32))
    active = torch.from_numpy(rng.random(m) < 0.5)
    want = _hold(card, dist, active, rowptr, colidx, w, deg)
    args = _on(card, dist, active, rowptr, colidx, w, deg)
    d1, a1, g1 = (torch.cat([t[:1], t])[1:] for t in (args[0], args[1],
                                                        args[5]))
    assert d1.is_contiguous() and d1.data_ptr() % 16 and a1.data_ptr() % 16
    got = sparse_relax(d1, a1, *_counts(active, deg), args[2], args[3],
                       args[4], g1)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["delta", "bf", "hybrid"])
@pytest.mark.parametrize("delta", [1, 16, 64])
def test_sssp_on_the_card_matches_the_cpu(card, variant, delta):
    """Weighted R-MAT-16: distances and rounds equal to the CPU route's,
    and one F1 launch a sparse round."""
    g = generate_graph("rmat", scale=16, degree=16, symmetrize=True,
                       weighted=True)
    src = int(np.argmax(g.degrees))
    want = sssp_solver(g, src, delta, variant=variant, device="cpu")
    P.take()
    before = trelax.LAUNCHES
    with P.recording():
        got = sssp_solver(g, src, delta, variant=variant, device=card)
    c = P.take()["counters"]
    assert torch.equal(got.dist.cpu(), want.dist)
    assert got.iterations == want.iterations
    assert trelax.LAUNCHES - before == c.get("sssp.rounds_sparse", 0) > 0
