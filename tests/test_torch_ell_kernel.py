"""Kernel E1 (csrc/ell_spmv.cu): spmv_ell's float32 plus-times apply in
one launch on a card, and the route that picks it.

The CPU tests hold the route (a CPU tensor, another semiring or a row mask
takes spmv_ell_plain, and nothing of the kernel library is loaded) and
E1's schedule (ops/spmv.e1_plan, e1_splits) by a numpy copy of the
kernel's index arithmetic.  The tests marked `gpu` need a CUDA card and
skip without one (decided in the `card` fixture); they hold E1 to
spmv_ell_plain.  This file imports no JAX, so on the card:

    python -m pytest tests/test_torch_ell_kernel.py -q --noconftest
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gardenia_tpu_torch.core.generate import generate_graph
from gardenia_tpu_torch.core.relabel import degree_relabel
from gardenia_tpu_torch.ops import panel as tpanel
from gardenia_tpu_torch.ops import spmv as tspmv
from gardenia_tpu_torch.ops.bsr import build_hybrid, spmv_hybrid
from gardenia_tpu_torch.ops.ell import EllMatrix, build_ell
from gardenia_tpu_torch.ops.semiring import (F32_MIN_PLUS, F32_PLUS_TIMES,
                                             I32_MIN_PLUS, I32_MIN_SELECT2,
                                             I32_PLUS_TIMES)
from gardenia_tpu_torch.ops.spmv import (E1_MAX_SPLITS, E1_THREAD_SLOTS,
                                         E1_THREADS, e1_plan, e1_splits,
                                         row_lengths, spmv_ell,
                                         spmv_ell_plain, takes_e1)

# max |E1 - plain| over max |plain|: f32 sums of the same terms in
# another order (E1 splits a wide row across warps, atomics combine the
# virtual rows of a row the width cap split)
REL_LIMIT = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def _graph(kind: str, scale: int = 12):
    g = generate_graph(kind, scale=scale, degree=16, symmetrize=True)
    return degree_relabel(g).graph


def _layout(g, weighted: bool, width_cap: int, dyadic: bool = False):
    """(EllMatrix, weights) of g's CSR: float32 weights, or multiples of
    1/4 up to 1 where `dyadic` (sums of them are exact in float32)."""
    w = None
    if weighted:
        rng = np.random.default_rng(5)
        w = (rng.integers(1, 5, g.nnz) / 4 if dyadic
             else rng.random(g.nnz) + 0.5).astype(np.float32)
    ell = build_ell(g.rowptr, g.colidx, w, num_cols=g.n,
                    width_cap=width_cap)
    return ell, w


def _operands(n: int, num_rows: int, dyadic: bool, seed: int = 7):
    rng = np.random.default_rng(seed)
    if dyadic:                # k / 256: every partial sum exact in f32
        x = rng.integers(0, 256, n) / 256
        init = rng.integers(0, 256, num_rows) / 256
    else:
        x, init = rng.random(n), rng.random(num_rows)
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(init.astype(np.float32)))


def _reference(g, w, x, num_rows, init=None) -> np.ndarray:
    """y[i] = sum_j w[i, j] x[j] over g's CSR in float64, rows < num_rows."""
    dst = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    vals = np.ones(g.nnz) if w is None else w.astype(np.float64)
    y = np.zeros(g.m)
    np.add.at(y, dst, vals * x.numpy().astype(np.float64)[g.colidx])
    y = y[:num_rows]
    return y if init is None else y + init.numpy()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# ---- the route and the schedule, on the CPU -------------------------------

def test_takes_e1_only_for_f32_plus_times_on_cuda_without_a_mask():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert takes_e1(cuda, F32_PLUS_TIMES, None)
    assert not takes_e1(cpu, F32_PLUS_TIMES, None)
    mask = torch.ones(4, dtype=torch.bool)
    assert not takes_e1(cuda, F32_PLUS_TIMES, mask)
    for sr in (I32_PLUS_TIMES, I32_MIN_PLUS, I32_MIN_SELECT2, F32_MIN_PLUS):
        assert not takes_e1(cuda, sr, None), sr.name


@pytest.mark.parametrize("sr", [F32_PLUS_TIMES, I32_PLUS_TIMES,
                                I32_MIN_SELECT2, I32_MIN_PLUS],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("masked", [False, True])
def test_cpu_spmv_ell_is_the_plain_version(sr, masked, monkeypatch):
    """On the CPU every semiring, with or without a row mask, takes the
    plain version: its result bit for bit, the library never loaded, no
    launch counted."""
    from gardenia_tpu_torch.ops import _build

    def no_library():
        raise AssertionError("the kernel library was asked for on the CPU")
    monkeypatch.setattr(_build, "lib", no_library)
    g = _graph("rmat", 9)
    ell, w = _layout(g, sr is I32_MIN_PLUS, width_cap=16)
    rng = np.random.default_rng(3)
    num_rows = g.m - 5
    x = torch.from_numpy(rng.integers(0, 50, g.n).astype(np.float32)
                         ).to(sr.dtype)
    init = torch.from_numpy(rng.integers(0, 50, num_rows)).to(sr.dtype)
    mask = torch.from_numpy(rng.random(num_rows) < 0.5) if masked else None
    before = dict(tspmv.LAUNCHES)
    got = spmv_ell(ell, x, semiring=sr, num_rows=num_rows, init=init,
                   row_mask=mask)
    want = spmv_ell_plain(ell, x, semiring=sr, num_rows=num_rows, init=init,
                          row_mask=mask)
    assert got.dtype == sr.dtype and torch.equal(got, want)
    assert tspmv.LAUNCHES == before
    if sr is F32_PLUS_TIMES and not masked:
        ref = _reference(g, None, x, num_rows, init)
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_plain_row_mask_keeps_init_rows():
    """The row mask's scalar fill (no uploaded zero) keeps the masked rows'
    init values and sums the others, as before."""
    g = _graph("uniform", 8)
    ell, _ = _layout(g, False, 256)
    x = torch.arange(g.n, dtype=torch.float32) % 7
    init = torch.full((g.m,), -1.0)
    mask = torch.arange(g.m) % 3 == 0
    got = spmv_ell(ell, x, num_rows=g.m, init=init, row_mask=mask)
    ref = _reference(g, None, x, g.m, init)
    assert torch.equal(got[~mask], init[~mask])
    assert np.allclose(got[mask].numpy(), ref[mask.numpy()], rtol=1e-6)


def test_cpu_apply_imports_no_kernel_code():
    """spmv_ell and spmv_hybrid on CPU tensors leave ops/_build unimported."""
    code = (
        "import sys, numpy as np, torch\n"
        "from gardenia_tpu_torch.core.generate import generate_graph\n"
        "from gardenia_tpu_torch.ops.bsr import build_hybrid, spmv_hybrid\n"
        "from gardenia_tpu_torch.ops.ell import build_ell\n"
        "from gardenia_tpu_torch.ops.spmv import spmv_ell\n"
        "g = generate_graph('rmat', scale=8, degree=16)\n"
        "x = torch.rand(g.n)\n"
        "spmv_ell(build_ell(g.rowptr, g.colidx, num_cols=g.n), x,"
        " num_rows=g.m)\n"
        "spmv_hybrid(build_hybrid(g.rowptr, g.colidx, num_cols=g.n), x,"
        " num_rows=g.m)\n"
        "assert 'gardenia_tpu_torch.ops._build' not in sys.modules\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


def test_e1_splits_are_the_fewest_warps_that_bound_a_thread():
    assert E1_MAX_SPLITS * 32 == E1_THREADS
    for W in range(0, 1025):
        splits = e1_splits(W)
        assert splits in (1, 2, 4, 8) and splits <= E1_MAX_SPLITS
        if splits < E1_MAX_SPLITS:
            assert -(-W // splits) <= E1_THREAD_SLOTS
        if splits > 1:
            assert -(-W // (splits // 2)) > E1_THREAD_SLOTS
    assert [e1_splits(W) for W in (8, 32, 33, 64, 128, 256, 512)] == \
        [1, 1, 2, 2, 4, 8, 8]


def test_e1_plan_orders_widest_first_and_prefixes_ctas():
    shapes = [(1, 640), (3, 128), (8, 0), (16, 384), (32, 896), (64, 128),
              (256, 256), (32, 5)]
    plan, ctas = e1_plan(shapes)
    assert plan.dtype == np.int64 and plan.shape == (len(shapes), 5)
    # widest first; equal widths keep the layout's order
    assert list(plan[:, 0]) == [6, 5, 4, 7, 3, 2, 1, 0]
    assert list(plan[:, 1]) == sorted((W for W, _ in shapes), reverse=True)
    first = 0
    for i, W, R, splits, f in plan:
        assert (W, R) == shapes[i] and splits == e1_splits(W) and f == first
        first += -(-R // (E1_THREADS // splits))
    assert ctas == first
    empty, none = e1_plan([])
    assert empty.shape == (0, 5) and none == 0


def _emulate_e1(ell: EllMatrix, x: torch.Tensor, y: torch.Tensor):
    """csrc/ell_spmv.cu's index arithmetic in numpy, thread by thread of
    every CTA: the bucket search, the row and slot phase of each thread,
    the row's length, the pad column and the dropped rows; y is added into
    in float64."""
    plan, ctas = e1_plan([tuple(b.cols.shape) for b in ell.buckets])
    n, num_rows = x.shape[0], y.shape[0]
    xs, out = x.double().numpy(), y.double().numpy().copy()
    seen = {}
    firsts = plan[:, 4]
    for cta in range(ctas):
        b = 0
        while b + 1 < len(plan) and cta >= firsts[b + 1]:
            b += 1
        i, W, R, splits, first = (int(v) for v in plan[b])
        bk = ell.buckets[i]
        cols, row_ids = bk.cols.numpy(), bk.row_ids.numpy()
        lens = row_lengths(bk.cols, n).numpy()
        vals = None if bk.vals is None else bk.vals.double().numpy()
        t = np.arange(E1_THREADS)
        warp = t >> 5
        row = (cta - first) * (E1_THREADS // splits) \
            + (warp // splits) * 32 + (t & 31)
        k = warp % splits
        for r, kk in zip(row, k):
            if r >= R:
                continue
            dst = int(row_ids[r])
            seen[(i, int(r), int(kk))] = seen.get((i, int(r), int(kk)), 0) + 1
            if not 0 <= dst < num_rows:
                continue
            ws = np.arange(kk, lens[r], splits)
            c = cols[ws, r]
            xv = np.where(c < n, xs[np.minimum(c, n - 1)], 0.0)
            out[dst] += (xv * (1.0 if vals is None else vals[ws, r])).sum()
    # every (bucket, virtual row, slot phase) taken by exactly one thread
    want = {(i, r, k) for i, b in enumerate(ell.buckets)
            for r in range(b.cols.shape[1])
            for k in range(e1_splits(b.cols.shape[0]))}
    assert set(seen) == want and set(seen.values()) <= {1}
    return out


@pytest.mark.parametrize("kind,weighted,width_cap,cut",
                         [("rmat", False, 256, 0), ("rmat", True, 16, 9),
                          ("uniform", True, 256, 3), ("rmat", False, 64, 0)])
def test_e1_index_arithmetic_matches_plain(kind, weighted, width_cap, cut):
    g = _graph(kind, 9)
    ell, w = _layout(g, weighted, width_cap)
    num_rows = g.m - cut
    x, init = _operands(g.n, num_rows, dyadic=False)
    got = _emulate_e1(ell, x, init)
    want = spmv_ell_plain(ell, x, num_rows=num_rows, init=init)
    assert np.abs(got - want.double().numpy()).max() \
        <= REL_LIMIT * want.abs().max().item()


def test_row_lengths_end_at_the_last_real_column():
    n = 10
    cols = torch.tensor([[0, n, n, 3, -1],
                         [4, n, 9, n, n],
                         [n, n, n, 11, n]], dtype=torch.int32)
    assert row_lengths(cols, n).tolist() == [2, 0, 2, 1, 0]
    assert row_lengths(cols, 12).tolist() == [3, 3, 3, 3, 3]
    assert row_lengths(cols, n).dtype == torch.int32
    assert row_lengths(torch.zeros((0, 4), dtype=torch.int32), n).tolist() \
        == [0, 0, 0, 0]
    g = _graph("rmat", 9)
    for b in _layout(g, False, 16)[0].buckets:      # build_ell: pads trail
        lens = row_lengths(b.cols, g.n)
        real = (b.cols < g.n).sum(0).to(torch.int32)
        assert torch.equal(lens, real)


def test_kernel_table_is_a_cache_outside_the_layout():
    g = _graph("rmat", 8)
    ell, _ = _layout(g, False, 256)
    assert ell.kernel_table is None
    ell.kernel_table = ("stale",)
    assert ell == EllMatrix(ell.buckets) and "kernel_table" not in repr(ell)
    assert ell.to("cpu").kernel_table is None


# ---- E1 on the card ------------------------------------------------------

@pytest.mark.gpu
def test_e1_library_threads_match_the_host_copy(card):
    from gardenia_tpu_torch.ops import _build
    assert _build.lib().gdn_ell_spmv_threads() == E1_THREADS


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rmat", "uniform"])
@pytest.mark.parametrize("width_cap", [256, 16])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("cut", [0, 11])
def test_e1_matches_plain(card, kind, width_cap, weighted, with_init, cut):
    """E1 against spmv_ell_plain on the card: within REL_LIMIT on random
    operands, bit for bit on dyadic ones (every sum exact); one launch an
    apply."""
    g = _graph(kind, 12)
    num_rows = g.m - cut
    for dyadic in (False, True):
        ell, w = _layout(g, weighted, width_cap, dyadic)
        ell = ell.to(card)
        x, init = _operands(g.n, num_rows, dyadic)
        x, init = x.to(card), init.to(card) if with_init else None
        before = tspmv.LAUNCHES["ell"]
        got = spmv_ell(ell, x, num_rows=num_rows, init=init)
        assert tspmv.LAUNCHES["ell"] == before + 1
        want = spmv_ell_plain(ell, x, num_rows=num_rows, init=init)
        torch.cuda.synchronize()
        assert got.shape == (num_rows,) and got.dtype == torch.float32
        if dyadic:
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) <= REL_LIMIT
            ref = _reference(g, w, x.cpu(), num_rows,
                             None if init is None else init.cpu())
            assert _rel(got, torch.from_numpy(ref)) <= REL_LIMIT


@pytest.mark.gpu
def test_e1_empty_layout(card):
    x = torch.rand(64, device=card)
    init = torch.rand(40, device=card)
    before = tspmv.LAUNCHES["ell"]
    assert torch.equal(spmv_ell(EllMatrix(()), x, num_rows=40),
                       torch.zeros(40, device=card))
    assert torch.equal(spmv_ell(EllMatrix(()), x, num_rows=40, init=init),
                       init)
    assert tspmv.LAUNCHES["ell"] == before


@pytest.mark.gpu
def test_e1_sentinel_columns_and_rows(card):
    """Hand-made buckets: pad columns (n) read 0, sentinel and cut rows
    are dropped, a row split across buckets sums its parts, init is not
    written."""
    n, num_rows = 10, 6
    cols = torch.tensor([[0, 9, n, 3], [n, 1, n, n]], dtype=torch.int32)
    rows = torch.tensor([2, 2, 5, num_rows], dtype=torch.int32)
    wide = torch.full((40, 3), n, dtype=torch.int32)
    wide[:, 0] = torch.arange(40) % n
    wide[5, 2] = 7
    wide_rows = torch.tensor([2, 4, 7], dtype=torch.int32)   # 7: cut row
    from gardenia_tpu_torch.ops.ell import EllBucket
    ell = EllMatrix((EllBucket(rows, cols, None),
                     EllBucket(wide_rows, wide, None))).to(card)
    x = torch.arange(1, n + 1, dtype=torch.float32, device=card)
    init = torch.full((num_rows,), 0.5, device=card)
    got = spmv_ell(ell, x, num_rows=num_rows, init=init)
    want = spmv_ell_plain(ell, x, num_rows=num_rows, init=init)
    assert torch.equal(got, want)
    assert torch.equal(init, torch.full((num_rows,), 0.5, device=card))


@pytest.mark.gpu
def test_e1_one_launch_and_no_sync(card):
    g = _graph("rmat", 12)
    ell, _ = _layout(g, True, 16)
    ell = ell.to(card)
    x = torch.rand(g.n, device=card)
    init = torch.rand(g.m, device=card)
    from gardenia_tpu_torch.ops import _build
    _build.lib()
    torch.cuda.synchronize()
    before = tspmv.LAUNCHES["ell"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = [spmv_ell(ell, x, num_rows=g.m, init=init) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tspmv.LAUNCHES["ell"] == before + 3
    want = spmv_ell_plain(ell, x, num_rows=g.m, init=init)
    for y in ys:
        assert _rel(y, want) <= REL_LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("sr", [I32_PLUS_TIMES, I32_MIN_SELECT2],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("masked", [False, True])
def test_other_applies_take_torch_on_the_card(card, sr, masked):
    g = _graph("rmat", 10)
    ell, _ = _layout(g, False, 256)
    x = torch.randint(0, 9, (g.n,), dtype=sr.dtype)
    mask = (torch.arange(g.m) % 2 == 0) if masked else None
    want = spmv_ell(ell, x, semiring=sr, num_rows=g.m, row_mask=mask)
    before = dict(tspmv.LAUNCHES)
    got = spmv_ell(ell.to(card), x.to(card), semiring=sr, num_rows=g.m,
                   row_mask=None if mask is None else mask.to(card))
    assert torch.equal(got.cpu(), want)
    assert tspmv.LAUNCHES == dict(before,
                                  ell_torch=before["ell_torch"] + 1)
    if masked:       # the float32 plus-times apply with a mask, likewise
        xf = x.float()
        want = spmv_ell(ell, xf, num_rows=g.m, row_mask=mask)
        got = spmv_ell(ell.to(card), xf.to(card), num_rows=g.m,
                       row_mask=mask.to(card))
        assert _rel(got, want) <= REL_LIMIT
        assert tspmv.LAUNCHES["ell"] == before["ell"]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dense_threshold", [("rmat", 16),
                                                  ("uniform", 1 << 30)])
def test_spmv_hybrid_on_the_card(card, kind, dense_threshold):
    """The hybrid apply: K1 on the panels and E1 on the remainder, adding
    into the panels' result (R-MAT), or E1 alone (no block dense enough);
    one E1 launch."""
    g = _graph(kind, 12)
    hyb = build_hybrid(g.rowptr, g.colidx, None, num_cols=g.n,
                       dense_threshold=dense_threshold)
    assert hyb.rem.buckets and bool(hyb.dense) == (kind == "rmat")
    x = torch.from_numpy(np.random.default_rng(4).random(g.n)
                         .astype(np.float32))
    want = spmv_hybrid(hyb, x, num_rows=g.m)
    before = tspmv.LAUNCHES["ell"]
    got = spmv_hybrid(hyb.to(card), x.to(card), num_rows=g.m)
    assert tspmv.LAUNCHES["ell"] == before + 1
    assert _rel(got, want) <= REL_LIMIT
    ref = _reference(g, None, x, g.m)
    assert _rel(got, torch.from_numpy(ref)) <= REL_LIMIT


@pytest.mark.gpu
def test_pr_on_the_card_matches_the_cpu(card):
    from gardenia_tpu_torch.solvers.pr import pr_solver
    # R-MAT-12: "auto" is the relabelled ELL layout on the card (one E1
    # launch an iteration, no K1) and the relabelled hybrid layout on the
    # CPU (5 panel arrays and a remainder)
    g = generate_graph("rmat", scale=12, degree=16, symmetrize=True)
    want = pr_solver(g, device="cpu")
    before, k1_before = tspmv.LAUNCHES["ell"], dict(tpanel.LAUNCHES)
    got = pr_solver(g, device=card)
    assert got.iterations == want.iterations
    assert tspmv.LAUNCHES["ell"] - before == got.iterations
    assert tpanel.LAUNCHES == k1_before
    assert _rel(got.scores, want.scores) <= REL_LIMIT


@pytest.mark.gpu
def test_pr_hybrid_on_the_card_matches_the_cpu(card):
    """layout="hybrid" on the card: each iteration K1 on every panel
    array and one E1 launch on the remainder."""
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.solvers.pr import pr_solver
    g = generate_graph("rmat", scale=12, degree=16, symmetrize=True)
    want = pr_solver(g, layout="hybrid", device="cpu")
    n_panels = len(views.relabeled_hybrid(g, card)[1].dense)
    assert n_panels > 0
    before, k1_before = tspmv.LAUNCHES["ell"], tpanel.LAUNCHES["simt"]
    got = pr_solver(g, layout="hybrid", device=card)
    assert got.iterations == want.iterations
    assert tspmv.LAUNCHES["ell"] - before == got.iterations
    assert tpanel.LAUNCHES["simt"] - k1_before == got.iterations * n_panels
    assert _rel(got.scores, want.scores) <= REL_LIMIT
