"""Kernel GS1 (csrc/symgs_sweep.cu): the sweep of one SymGS colour block in
one launch on a card, and the route that picks it (ops/symgs_sweep).

The CPU tests hold the route (CPU tensors take sweep_block_plain and load
nothing of the kernel library; other devices raise), the checks that
color_ordered makes once when it builds a system (fewer than 2^31 rows, a
proper colouring on every device), its int32 positions and widest rows, the launch counter as the recorder reads it, the solver's
answer against the sweep as it stood before GS1, and a numpy copy of GS1's
arithmetic (`emulate_gs1`: a row's lanes in strides of L, their xor-shuffle
tree), which a mocked card route runs through whole solves.  The tests
marked `gpu` need a CUDA card and skip without one (decided in the `card`
fixture); they hold GS1 to sweep_block_plain within 1e-6 relative, block
by block.  This file imports no JAX, so on the card:

    python -m pytest tests/test_torch_symgs_sweep.py -q --noconftest
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gardenia_tpu_torch.core.generate import generate_graph
from gardenia_tpu_torch.core.graph import Graph
from gardenia_tpu_torch.ops import symgs_sweep as tsweep
from gardenia_tpu_torch.ops.symgs_sweep import (group_lanes, sweep_block,
                                                sweep_block_plain)
from gardenia_tpu_torch.solvers import symgs as tsymgs
from gardenia_tpu_torch.solvers.vc import vc_solver
from gardenia_tpu_torch.utils import profiler as P
from gardenia_tpu_torch.verify import oracles

from graphbench import generators, manifest, run

REL = 1e-6      # GS1 against the plain sweep: only a row's sum order differs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


# ---- systems ---------------------------------------------------------------

def hpcg(scale: int) -> Graph:
    """graphbench's hpcg20 stencil (HPCG's 27-point matrix) at `scale`."""
    cfg = dict(manifest.config(manifest.load_benchmark(), "hpcg20"))
    cfg["scale"] = scale
    return run.build_graph(generators.generate(cfg, 2**31 + scale, "cpu"),
                           cfg)


def isolated_graph() -> Graph:
    """An R-MAT-8 graph with its first 5 vertices cut loose: empty rows."""
    g = generate_graph("rmat", scale=8, degree=8, symmetrize=True)
    src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    keep = (src >= 5) & (g.colidx >= 5)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(src[keep],
                                                        minlength=g.m))])
    return Graph(rowptr.astype(np.int64), g.colidx[keep], symmetric=True)


def inputs(g, seed=13, zero_diag=0):
    """(Ax, x0, b, diag, colors) drawn from `seed`, the port's colouring;
    every zero_diag-th diagonal entry 0 (rows that keep their x)."""
    rng = np.random.default_rng(seed)
    Ax = rng.random(g.nnz).astype(np.float32)
    x0 = rng.random(g.m).astype(np.float32)
    b = rng.random(g.m).astype(np.float32)
    diag = (g.degrees + 1).astype(np.float32)
    if zero_diag:
        diag[::zero_diag] = 0
    return Ax, x0, b, diag, vc_solver(g, device="cpu").colors.numpy()


def before_gs1(g, Ax, x0, b, diag, colors) -> torch.Tensor:
    """One application as solvers/symgs computed it before GS1: int64
    column positions, a gather, a product, a segment sum and a where a
    block, forward then backward."""
    order = np.argsort(colors, kind="stable")
    pos = np.empty(g.m, np.int64)
    pos[order] = np.arange(g.m)
    rp = np.asarray(g.rowptr, np.int64)
    lens = np.diff(rp)[order]
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    eidx = np.repeat(rp[order] - rowptr[:-1], lens) + np.arange(rowptr[-1])
    col = torch.from_numpy(pos[np.asarray(g.colidx, np.int64)[eidx]])
    val = torch.from_numpy(Ax[eidx])
    bo = torch.from_numpy(b[order])
    do = torch.from_numpy(diag[order])
    ends = np.cumsum(np.bincount(colors))
    starts = ends - np.bincount(colors)
    blocks = [(s, e) for s, e in zip(starts, ends) if e > s]
    x = torch.from_numpy(x0[order].copy())
    for r0, r1 in blocks + blocks[::-1]:
        e0, e1 = rowptr[r0], rowptr[r1]
        prod = val[e0:e1] * x[col[e0:e1]]
        rsum = torch.segment_reduce(
            prod, "sum", offsets=torch.from_numpy(rowptr[r0:r1 + 1] - e0),
            initial=0.0)
        xs = x[r0:r1]
        torch.where(do[r0:r1] != 0, (bo[r0:r1] - rsum) / do[r0:r1], xs,
                    out=xs)
    out = torch.empty_like(x)
    out[torch.from_numpy(order)] = x
    return out


# ---- a numpy copy of GS1's arithmetic --------------------------------------

def emulate_gs1(col, val, b, diag, update, x, block) -> None:
    """GS1 on CPU tensors, in float32 as the kernel rounds: lane l of a
    row's group of L = group_lanes(width) sums the products of arcs l,
    l + L, ... in order; the lanes' parts meet in the xor-shuffle tree
    (off = L/2 .. 1); lane 0's sum updates the row."""
    r0, r1, offsets, e0, _, width = block
    L = group_lanes(width)
    start = e0 + offsets[:-1]
    end = e0 + offsets[1:]
    part = torch.zeros(r1 - r0, L, dtype=torch.float32)
    lane = torch.arange(L)
    for j in range(-(-max(width, 1) // L)):
        k = start[:, None] + lane[None, :] + j * L
        live = k < end[:, None]
        kk = torch.where(live, k, 0)
        prod = val[kk] * x[col[kk].long()]
        part = part + torch.where(live, prod, torch.zeros(()))
    off = L // 2
    while off:
        part = part + part[:, lane ^ off]
        off //= 2
    xs = x[r0:r1]
    torch.where(update[r0:r1], (b[r0:r1] - part[:, 0]) / diag[r0:r1], xs,
                out=xs)


@pytest.fixture
def mocked_card(monkeypatch):
    """sweep_block's card route on CPU tensors: GS1's launch replaced by
    emulate_gs1, the plain version forbidden, LAUNCHES from 0; yields the
    blocks launched."""
    calls = []

    def fake_gs1(col, val, b, diag, update, x, block):
        calls.append(block)
        emulate_gs1(col, val, b, diag, update, x, block)

    def no_plain(*args):
        raise AssertionError("the plain sweep ran on the card route")
    monkeypatch.setattr(tsweep, "takes_gs1", lambda device: True)
    monkeypatch.setattr(tsweep, "_gs1", fake_gs1)
    monkeypatch.setattr(tsweep, "sweep_block_plain", no_plain)
    monkeypatch.setattr(tsweep, "LAUNCHES", 0)
    return calls


def gap(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


FIXTURES = {
    "rmat10": lambda: (generate_graph("rmat", scale=10, symmetrize=True), 0),
    "zero_diag": lambda: (generate_graph("uniform", scale=9,
                                         symmetrize=True), 7),
    "isolated": lambda: (isolated_graph(), 0),
    "hpcg12": lambda: (hpcg(12), 0),
}


# ---- the route and the counter, on the CPU ---------------------------------

def test_group_lanes_hold_the_widest_row():
    assert [group_lanes(w) for w in (0, 1, 8, 9, 16, 17, 26, 32, 33, 5000)] \
        == [8, 8, 8, 16, 16, 32, 32, 32, 32, 32]


def test_cpu_takes_the_plain_sweep(monkeypatch):
    """On the CPU sweep_block is sweep_block_plain, bit for bit: the
    library never loaded, no launch counted."""
    from gardenia_tpu_torch.ops import _build

    def no_library():
        raise AssertionError("the kernel library was asked for on the CPU")
    monkeypatch.setattr(_build, "lib", no_library)
    g = generate_graph("rmat", scale=9, symmetrize=True)
    Ax, x0, b, diag, colors = inputs(g)
    sys_ = tsymgs.color_ordered(g, Ax, b, diag, colors, "cpu")
    args = (sys_.col, sys_.val, sys_.b, sys_.diag, sys_.update)
    before = tsweep.LAUNCHES
    for block in sys_.blocks:
        x1 = torch.from_numpy(x0.copy())
        x2 = x1.clone()
        sweep_block(*args, x1, block)
        sweep_block_plain(*args, x2, block)
        assert torch.equal(x1, x2)
    assert tsweep.LAUNCHES == before


def test_takes_gs1_by_device():
    assert tsweep.takes_gs1(torch.device("cuda"))
    assert tsweep.takes_gs1(torch.device("cuda:1"))
    assert not tsweep.takes_gs1(torch.device("cpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        tsweep.takes_gs1(torch.device("meta"))


def test_other_devices_raise():
    g = generate_graph("rmat", scale=6, symmetrize=True)
    Ax, x0, b, diag, colors = inputs(g)
    sys_ = tsymgs.color_ordered(g, Ax, b, diag, colors, "cpu")
    x = torch.zeros(g.m, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sweep_block(sys_.col, sys_.val, sys_.b, sys_.diag, sys_.update, x,
                    sys_.blocks[0])
    with pytest.raises(ValueError, match="unsupported device"):
        tsymgs.symgs_solver(g, Ax, x0, b, diag, colors, device="meta")


def test_cpu_symgs_imports_no_kernel_code():
    """A CUDA-less SymGS solve never imports ops/_build."""
    code = (
        "import sys\n"
        "from gardenia_tpu_torch.core.generate import generate_graph\n"
        "from gardenia_tpu_torch.solvers.symgs import symgs_solver\n"
        "g = generate_graph('rmat', scale=8, symmetrize=True)\n"
        "symgs_solver(g, device='cpu')\n"
        "assert 'gardenia_tpu_torch.ops._build' not in sys.modules\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


def test_launches_symgs_sweep_is_read_by_the_recorder(monkeypatch):
    monkeypatch.setattr(tsweep, "LAUNCHES", 7)
    P.take()
    with P.recording():
        P.count("x")
    assert P.take()["counters"]["launches.symgs_sweep"] == 7


# ---- color_ordered's layout and its checks ---------------------------------

@pytest.mark.parametrize("fixture", ["rmat10", "hpcg12", "isolated"])
def test_color_ordered_keeps_int32_positions_and_widest_rows(fixture):
    g, _ = FIXTURES[fixture]()
    Ax, _, b, diag, colors = inputs(g)
    sys_ = tsymgs.color_ordered(g, Ax, b, diag, colors, "cpu")
    order = sys_.order.numpy()
    pos = np.empty(g.m, np.int64)
    pos[order] = np.arange(g.m)
    assert sys_.col.dtype == torch.int32
    # the arcs of each ordered row, in the row's CSR order
    want = np.concatenate([pos[g.colidx[g.rowptr[u]:g.rowptr[u + 1]]]
                           for u in order])
    np.testing.assert_array_equal(sys_.col.numpy().astype(np.int64), want)
    deg = np.diff(g.rowptr)
    for r0, r1, offsets, e0, e1, width in sys_.blocks:
        assert width == deg[order[r0:r1]].max()
        assert offsets[-1] == e1 - e0
    widths = {blk[5] for blk in sys_.blocks}
    if fixture == "hpcg12":
        assert max(widths) == 26
    if fixture == "rmat10":
        assert max(widths) > 32


def test_color_ordered_refuses_2_31_rows():
    """GS1 takes int32 column positions: a system of 2^31 rows is refused
    before anything is built."""
    class Huge:
        m = 2 ** 31
    with pytest.raises(ValueError, match="2\\^31"):
        tsymgs.color_ordered(Huge(), None, None, None, None, "cpu")


def test_the_system_is_checked_once_when_built(monkeypatch):
    """check_proper runs when color_ordered builds the system, and never
    again for the solves that reuse it."""
    calls = []
    real = tsymgs.check_proper

    def spy(*args):
        calls.append(1)
        real(*args)
    monkeypatch.setattr(tsymgs, "check_proper", spy)
    g = generate_graph("rmat", scale=8, symmetrize=True)
    Ax, x0, b, diag, colors = inputs(g)
    for _ in range(3):
        tsymgs.symgs_solver(g, Ax, x0, b, diag, colors, device="cpu")
    assert len(calls) == 1


def improper(g, colors) -> np.ndarray:
    """colors with the widest row's first neighbour given the row's own
    colour: one arc (two, symmetric) inside a colour."""
    u = int(np.argmax(g.degrees))
    bad = colors.copy()
    bad[g.colidx[g.rowptr[u]]] = bad[u]
    return bad


@pytest.mark.parametrize("entry", ["color_ordered", "symgs_solver"])
@pytest.mark.parametrize("fixture", ["rmat10", "isolated", "hpcg12"])
def test_an_improper_colouring_is_refused_on_the_cpu(fixture, entry):
    """GS1 sweeps a block in place, so every route refuses a colouring with
    an arc inside a colour, the CPU's as the card's; the proper colouring
    of the same system is taken."""
    g, _ = FIXTURES[fixture]()
    Ax, x0, b, diag, colors = inputs(g)
    bad = improper(g, colors)
    assert not oracles.vc_check(g, bad)
    if entry == "color_ordered":
        tsymgs.color_ordered(g, Ax, b, diag, colors, "cpu")
        with pytest.raises(ValueError, match="not proper"):
            tsymgs.color_ordered(g, Ax, b, diag, bad, "cpu")
    else:
        tsymgs.symgs_solver(g, Ax, x0, b, diag, colors, device="cpu")
        with pytest.raises(ValueError, match="not proper"):
            tsymgs.symgs_solver(g, Ax, x0, b, diag, bad, device="cpu")


def test_a_self_arc_is_not_a_conflict():
    """A row's arc to itself joins no two rows: a self-arc on every third
    row leaves a proper colouring proper."""
    g = generate_graph("rmat", scale=8, symmetrize=True)
    Ax, _, b, diag, colors = inputs(g)
    src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    loops = np.arange(0, g.m, 3)
    s2 = np.concatenate([src, loops])
    d2 = np.concatenate([g.colidx, loops])
    o = np.lexsort((d2, s2))
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(s2, minlength=g.m))])
    gl = Graph(rowptr.astype(np.int64), d2[o].astype(g.colidx.dtype),
               symmetric=True)
    Al = np.random.default_rng(1).random(gl.nnz).astype(np.float32)
    tsymgs.color_ordered(gl, Al, b, diag, colors, "cpu")


# ---- the solver's answer ---------------------------------------------------

@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_the_cpu_answer_is_the_sweep_before_gs1(fixture):
    """The CPU route equals, bit for bit, the application as the solver
    computed it before GS1 (int64 positions), and the serial float64
    sweep within the CLI's l2 1e-4; zero-diagonal rows keep x0, empty
    rows take b / diag."""
    g, zero = FIXTURES[fixture]()
    Ax, x0, b, diag, colors = inputs(g, zero_diag=zero)
    got = tsymgs.symgs_solver(g, Ax, x0, b, diag, colors, device="cpu").x
    assert torch.equal(got, before_gs1(g, Ax, x0, b, diag, colors))
    order = np.argsort(colors, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(colors))])
    want = oracles.symgs_serial(g, order, Ax, diag, x0, b, offsets)
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < 1e-4
    if zero:
        np.testing.assert_array_equal(got.numpy()[::zero], x0[::zero])
    empty = np.flatnonzero(np.diff(g.rowptr) == 0)
    if fixture == "isolated":
        assert set(range(5)) <= set(empty)
        np.testing.assert_array_equal(got.numpy()[empty],
                                      b[empty] / diag[empty])


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_mocked_card_route_launches_once_a_block(fixture, mocked_card):
    """With the card route forced on CPU tensors and GS1's launch replaced
    by emulate_gs1, a solve matches the plain route within REL, launches
    once a block (launches.symgs_sweep = symgs.blocks) and runs no plain
    block."""
    g, zero = FIXTURES[fixture]()
    args = inputs(g, zero_diag=zero)
    want = before_gs1(g, *args)
    P.take()
    with P.recording():
        got = tsymgs.symgs_solver(g, *args, device="cpu").x
    c = P.take()["counters"]
    assert gap(got, want) <= REL
    assert c["launches.symgs_sweep"] == c["symgs.blocks"] == len(mocked_card)
    assert len(mocked_card) == 2 * len(np.unique(args[4]))


# ---- GS1 on the card -------------------------------------------------------

def card_cases(kind):
    if kind == "hpcg16":
        return hpcg(16), 0
    if kind == "rmat16":
        return generate_graph("rmat", scale=16, symmetrize=True), 0
    return isolated_graph(), 5          # empty rows and update-false rows


def hold_blocks(dev, g, zero):
    """GS1 against sweep_block_plain on the card, block by block through
    one application (forward, then backward), each block at its own L
    and at every L of LANES; returns the widths met."""
    Ax, x0, b, diag, colors = inputs(g, zero_diag=zero)
    sys_ = tsymgs.color_ordered(g, Ax, b, diag, colors, dev)
    args = (sys_.col, sys_.val, sys_.b, sys_.diag, sys_.update)
    x = torch.from_numpy(x0).to(dev)[sys_.order]
    for block in sys_.blocks + sys_.blocks[::-1]:
        r0, r1 = block[:2]
        want = x.clone()
        sweep_block_plain(*args, want, block)
        for width in (block[5],) + tsweep.LANES:
            got = x.clone()
            before = tsweep.LAUNCHES
            sweep_block(*args, got, block[:5] + (width,))
            torch.cuda.synchronize()
            assert tsweep.LAUNCHES == before + 1
            assert gap(got[r0:r1], want[r0:r1]) <= REL, (block[:2], width)
            assert torch.equal(got[:r0], want[:r0])
            assert torch.equal(got[r1:], want[r1:])
        x = want
    return {blk[5] for blk in sys_.blocks}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hpcg16", "rmat16", "isolated"])
def test_gs1_matches_plain_block_by_block(card, kind):
    g, zero = card_cases(kind)
    widths = hold_blocks(card, g, zero)
    if kind == "hpcg16":
        assert max(widths) == 26
    if kind == "rmat16":
        # rows wider than 32: the strided loop at every L (each R-MAT
        # block asks for L = 32 itself; hold_blocks runs it at each L)
        assert max(widths) > 32


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hpcg16", "rmat16", "isolated"])
def test_symgs_on_the_card_launches_gs1_once_a_block(card, kind,
                                                      monkeypatch):
    """A whole application on the card: launches.symgs_sweep equals
    symgs.blocks, no plain block runs, and x matches the CPU route."""
    def no_plain(*args):
        raise AssertionError("the plain sweep ran on the card")
    g, zero = card_cases(kind)
    args = inputs(g, zero_diag=zero)
    want = tsymgs.symgs_solver(g, *args, device="cpu").x
    monkeypatch.setattr(tsweep, "sweep_block_plain", no_plain)
    P.take()
    before = tsweep.LAUNCHES
    with P.recording():
        got = tsymgs.symgs_solver(g, *args, device=card).x
    c = P.take()["counters"]
    assert tsweep.LAUNCHES - before == c["symgs.blocks"] \
        == c["launches.symgs_sweep"] - before \
        == 2 * len(np.unique(args[4]))
    assert gap(got.cpu(), want) <= REL


@pytest.mark.gpu
@pytest.mark.parametrize("nrows", [1, 3, 4, 5, 9, 64, 1027])
def test_gs1_on_hand_made_blocks(card, nrows):
    """One block of nrows rows (a group takes four: counts around it),
    its rows of 0, 1, 7, 8, 9, 31, 32, 33 and 65 arcs in turn into x
    outside the block, update false on every fifth row, at each L."""
    rng = np.random.default_rng(nrows)
    m, r0 = 4096, 1000
    lens = np.array([0, 1, 7, 8, 9, 31, 32, 33, 65])[np.arange(nrows) % 9]
    offsets = np.concatenate([[0], np.cumsum(lens)])
    outside = np.concatenate([np.arange(r0), np.arange(r0 + nrows, m)])
    e0 = 17
    col = rng.integers(0, m, e0 + int(offsets[-1]) + 5)
    col[e0:e0 + offsets[-1]] = rng.choice(outside, int(offsets[-1]))
    val = rng.random(col.shape[0]).astype(np.float32)
    b = rng.random(m).astype(np.float32)
    diag = (rng.random(m) + 1).astype(np.float32)
    update = np.ones(m, bool)
    update[r0:r0 + nrows:5] = False
    args = [torch.from_numpy(a).to(card) for a in (
        col.astype(np.int32), val, b, diag, update)]
    x = torch.from_numpy(rng.random(m).astype(np.float32)).to(card)
    block = (r0, r0 + nrows, torch.from_numpy(offsets).to(card), e0,
             e0 + int(offsets[-1]), int(lens.max()))
    want = x.clone()
    sweep_block_plain(*args, want, block)
    for width in (block[5],) + tsweep.LANES:
        got = x.clone()
        sweep_block(*args, got, block[:5] + (width,))
        torch.cuda.synchronize()
        assert gap(got, want) <= REL
        assert torch.equal(got[r0:r0 + nrows:5], x[r0:r0 + nrows:5])
        empty = r0 + np.flatnonzero(lens == 0)
        empty = empty[(empty - r0) % 5 != 0]
        assert torch.equal(got[empty], args[2][empty] / args[3][empty])
