"""The port's SymGS on the benchmark's HPCG matrix (graphbench's hpcg20 at
small scales, on the CPU): the 27-point stencil generator, the port
against the plain float64 reference (graphbench/reference_symgs.py) under
its own colouring and a hand 8-colouring, the hpcg20-symgs cell's check,
controls, readers and rehearsal, the urand20-tc cell's rehearsal, the
sweep's spans and counters (utils/profiler), and the solver's inputs made
once per graph."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gardenia_tpu_torch.solvers import symgs as tsymgs
from gardenia_tpu_torch.utils import profiler as P

from graphbench import generators, manifest, reference, reference_symgs, run
from graphbench.generators import stencil27
from graphbench.kernels import symgs as ksymgs

DIAG, OFF = 26.0, -1.0


def hpcg20(scale=None):
    cfg = dict(manifest.config(manifest.load_benchmark(), "hpcg20"))
    if scale is not None:
        cfg["scale"] = scale
    return cfg


@pytest.fixture(scope="module", params=[10, 12], ids=["hpcg10", "hpcg12"])
def stencil(request):
    """(cfg, raw edges, the port's Graph, the reference's CSR, x0) of a
    small HPCG grid."""
    cfg = hpcg20(request.param)
    edges = generators.generate(cfg, 2**31 + request.param, "cpu")
    g = run.build_graph(edges, cfg)
    ref = reference.clean_csr(edges.m, edges.src, edges.dst)
    x0 = torch.rand(edges.m, generator=generators.device_generator(
        request.param, "cpu"))
    return cfg, edges, g, ref, x0


def grid(scale):
    nx, ny, nz = stencil27.dims(scale)
    ids = torch.arange(nx * ny * nz)
    return (nx, ny, nz), (ids % nx, ids // nx % ny, ids // (nx * ny))


def test_the_dims_follow_the_scale_alone():
    cfg = hpcg20()
    assert list(stencil27.dims(cfg["scale"])) == cfg["dims"] == [128, 128, 64]
    assert stencil27.dims(10) == (16, 8, 8)
    assert stencil27.dims(12) == (16, 16, 16)
    for scale in range(3, 25):
        nx, ny, nz = stencil27.dims(scale)
        assert nx * ny * nz == 1 << scale and nx >= ny >= nz >= 2
        assert nx <= 2 * nz


@pytest.mark.parametrize("scale", [10, 12])
def test_the_stencil_has_hpcgs_arcs_and_degrees(scale):
    cfg = hpcg20(scale)
    e1 = generators.generate(cfg, 2**31 + 1, "cpu")
    e2 = generators.generate(cfg, 7, "cpu")
    assert torch.equal(e1.src, e2.src) and torch.equal(e1.dst, e2.dst)
    assert e1.wt is None and e1.src.dtype == torch.int32
    assert bool((e1.src < e1.dst).all())        # the 13 forward offsets
    (nx, ny, nz), (ix, iy, iz) = grid(scale)
    ref = reference.clean_csr(e1.m, e1.src, e1.dst)
    assert ref.m == nx * ny * nz == 1 << scale
    assert ref.arcs == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2) - ref.m
    assert ref.arcs == 2 * len(e1.src)          # no duplicate
    deg = ref.degrees
    interior = ((ix > 0) & (ix < nx - 1) & (iy > 0) & (iy < ny - 1)
                & (iz > 0) & (iz < nz - 1))
    corner = (((ix == 0) | (ix == nx - 1)) & ((iy == 0) | (iy == ny - 1))
              & ((iz == 0) | (iz == nz - 1)))
    assert bool((deg[interior] == 26).all())
    assert int(interior.sum()) == (nx - 2) * (ny - 2) * (nz - 2)
    assert bool((deg[corner] == 7).all()) and int(corner.sum()) == 8
    assert int(deg.min()) == 7 and int(deg.max()) == 26
    # a row's neighbours are the grid points one step away in each axis
    r = int(torch.nonzero(interior)[0])
    nbrs = ref.cols[ref.rowptr[r]:ref.rowptr[r + 1]]
    step = torch.stack([ix[nbrs] - ix[r], iy[nbrs] - iy[r],
                        iz[nbrs] - iz[r]])
    assert int(step.abs().max()) == 1 and bool(step.abs().sum(0).gt(0).all())


def parity_colors(scale) -> np.ndarray:
    """HPCG's hand 8-colouring: (ix % 2, iy % 2, iz % 2)."""
    _, (ix, iy, iz) = grid(scale)
    return ((ix % 2) + 2 * (iy % 2) + 4 * (iz % 2)).numpy().astype(np.int32)


def port_x(g, ref, x0, colors):
    b = reference_symgs.rhs(ref, DIAG, OFF).numpy().astype(np.float32)
    return tsymgs.symgs_solver(g, np.full(g.nnz, OFF, np.float32),
                               x0.numpy(), b, np.full(g.m, DIAG, np.float32),
                               colors, device="cpu").x


def gap(x, r) -> float:
    return float((x.to(r) - r).abs().max() / r.abs().max())


@pytest.mark.parametrize("colouring", ["port", "parity"])
def test_port_matches_the_float64_reference(stencil, colouring):
    cfg, _, g, ref, x0 = stencil
    if colouring == "port":
        from gardenia_tpu_torch.solvers.vc import vc_solver
        colors = vc_solver(g, device="cpu").colors.numpy()
    else:
        colors = parity_colors(cfg["scale"])
    assert ksymgs.color_conflicts(ref, colors) == 0
    x = port_x(g, ref, x0, colors)
    b = reference_symgs.rhs(ref, DIAG, OFF)
    r = reference_symgs.symgs(ref, x0, b, torch.as_tensor(colors),
                              diagonal=DIAG, off_diagonal=OFF)
    assert x.dtype == torch.float32
    assert gap(x, r) <= ksymgs.LIMITS["x_gap"]
    # every row moves, and the residual falls
    assert bool((r != x0.double()).all())
    kw = {"diagonal": DIAG, "off_diagonal": OFF}
    assert reference_symgs.residual(ref, r, b, **kw) < \
        0.5 * reference_symgs.residual(ref, x0, b, **kw)


def test_the_reference_solves_hpcgs_system(stencil):
    # b is each row's sum: all ones is a fixed point, and each sweep
    # brings x nearer to it
    cfg, _, _, ref, x0 = stencil
    b = reference_symgs.rhs(ref, DIAG, OFF)
    colors = torch.as_tensor(parity_colors(cfg["scale"]))
    kw = {"diagonal": DIAG, "off_diagonal": OFF}
    ones = torch.ones(ref.m, dtype=torch.float64)
    assert reference_symgs.residual(ref, ones, b, **kw) == 0.0
    assert torch.equal(reference_symgs.symgs(ref, ones, b, colors, **kw),
                       ones)
    x, err = x0.double(), []
    for _ in range(6):
        x = reference_symgs.symgs(ref, x, b, colors, **kw)
        err.append(float(torch.linalg.vector_norm(x - 1)))
    assert all(a > b for a, b in zip(err, err[1:]))


def cell_run(stencil, n=3):
    """The check's inputs as the hpcg20-symgs cell makes them: the plan
    and n trials' answers."""
    cfg, edges, g, ref, _ = stencil
    mix = manifest.mix("symgs")
    plan = ksymgs.plan(edges, cfg, mix, 2**31 + 3)
    trials = ksymgs.Trials(g, torch.device("cpu"), mix, plan)
    outputs = [(0, trials.first())]
    outputs += [(i, trials(i)) for i in range(1, n)]
    return cfg, mix, plan, ref, outputs


def test_check_reads_zero_on_the_programs_answers(stencil):
    cfg, mix, plan, ref, outputs = cell_run(stencil)
    got = ksymgs.check(outputs, ref, cfg, mix, plan)
    numbers = dict((k, v) for k, v, _ in got["numbers"])
    assert numbers["color_conflicts"] == 0
    assert 0 < numbers["x_gap"] <= ksymgs.LIMITS["x_gap"]
    assert got["failed"] == 0
    info = got["info"]
    assert info["answers_checked"] == 3 and info["answers_wrong"] == 0
    assert info["num_colors"] == int(outputs[0][1][1].max()) + 1 >= 8
    assert (info["vertices"], info["arcs"]) == (ref.m, ref.arcs)
    assert info["residual_after"] < info["residual_x0"]
    # every trial is the same application of the same x0
    assert all(torch.equal(x, outputs[0][1][0]) for _, (x, _) in outputs)


@pytest.mark.parametrize("name", ksymgs.CONTROLS)
def test_each_control_reads_over_the_limit(stencil, name, monkeypatch):
    cfg, mix, plan, ref, outputs = cell_run(stencil)
    monkeypatch.setattr(ksymgs, "CONTROLS", (name,))
    answers = ksymgs.control(ref, cfg, mix, plan, outputs)
    assert len(answers) == len(outputs)
    got = ksymgs.check(answers, ref, cfg, mix, plan)
    numbers = dict((k, v) for k, v, _ in got["numbers"])
    assert numbers["x_gap"] > 10 * ksymgs.LIMITS["x_gap"]
    assert numbers["color_conflicts"] == 0
    assert got["failed"] == len(outputs)


def test_one_altered_entry_reads_over_the_limit(stencil):
    cfg, mix, plan, ref, outputs = cell_run(stencil)
    i, (x, colors) = outputs[1]
    x = x.clone()
    x[ref.m // 2] += 1e-3
    outputs[1] = (i, (x, colors))
    got = ksymgs.check(outputs, ref, cfg, mix, plan)
    assert got["numbers"][1][1] > ksymgs.LIMITS["x_gap"]
    assert got["failed"] == 1


def test_two_adjacent_rows_of_one_colour_read_a_conflict(stencil):
    cfg, mix, plan, ref, outputs = cell_run(stencil)
    i, (x, colors) = outputs[2]
    colors = colors.copy()
    colors[1] = colors[0]                       # (0,0,0) and (1,0,0)
    outputs[2] = (i, (x, colors))
    got = ksymgs.check(outputs, ref, cfg, mix, plan)
    assert got["numbers"][0][1] >= 2            # both arcs of the pair
    assert got["failed"] >= 1
    bad = colors.copy()
    bad[5] = -1
    assert ksymgs.color_conflicts(ref, bad) >= 1
    outputs[2] = (i, (x, bad))
    got = ksymgs.check(outputs, ref, cfg, mix, plan)
    assert got["numbers"][1][1] == 1.0 and got["failed"] == 1


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("workload", ["hpcg20-symgs", "urand20-tc"])
def test_cell_rehearses_correct(workload, trace):
    bench = manifest.load_benchmark()
    res, lines = run.run_cell(bench, workload, 2**31 + 55, 0.3, trace,
                              "cpu", cfg_override={"scale": 10},
                              t_start=time.perf_counter())
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    json.dumps(res)
    assert lines[-len(res["checks"]):] == [
        f"check {k} = {v['value']} (limit {v['limit']})"
        for k, v in res["checks"].items()]
    if trace:
        # the CPU has no device trace: the host-clock metrics and the
        # program's colour count remain
        want = {"graph_build_s", "first_trial_s"}
        if workload == "hpcg20-symgs":
            want.add("symgs_colors")
        assert set(res["metrics"]) == want
    else:
        want = {m["name"] for m in manifest.end_to_end(bench, workload)}
        assert set(res["metrics"]) == want


def read(metric, run_):
    return manifest.metric(metric).read(run_)


def test_the_readers_on_a_hand_made_run():
    roof = manifest.metric("symgs_roofline_pct")
    # scale 20: 2 x (8 B x 26,676,984 arcs + 16 B x 2^20 rows)
    assert roof.trial_bytes(1 << 20, 26_676_984) == 460_386_176
    run_ = {"trace": {"busy_s": 0.5, "trials": 10, "window_s": 5.0},
            "peaks": {"hbm_bytes_per_s": 1e9},
            "graph": {"vertices": 1000, "arcs": 20000},
            "reference": {"num_colors": 13}}
    # 2 x (160,000 + 16,000) B / 1e9 B/s = 352 us of 50 ms busy
    assert read("symgs_roofline_pct", run_) == pytest.approx(0.704)
    assert read("symgs_colors", run_) == 13
    assert read("symgs_roofline_pct", dict(run_, trace=None)) is None
    assert read("symgs_roofline_pct", dict(run_, peaks=None)) is None
    assert read("symgs_colors", dict(run_, reference={})) is None


def spans(got, name):
    return [s for s in got["spans"] if s[2] == name]


def test_the_sweep_records_one_span_a_block(stencil):
    cfg, _, g, ref, x0 = stencil
    args = (np.full(g.nnz, OFF, np.float32), x0.numpy(),
            reference_symgs.rhs(ref, DIAG, OFF).numpy().astype(np.float32),
            np.full(g.m, DIAG, np.float32), parity_colors(cfg["scale"]))
    tsymgs.symgs_solver(g, *args, device="cpu")   # the ordered system built
    P.take()
    with P.recording():
        tsymgs.symgs_solver(g, *args, device="cpu")
    got = P.take()
    blocks = spans(got, "symgs.block")
    solve, = spans(got, "solve.symgs")
    assert len(blocks) == got["counters"]["symgs.blocks"] == 2 * 8
    assert all(s[1] == solve[0] for s in blocks)
    assert got["counters"]["symgs.arcs"] == 2 * g.nnz == 2 * ref.arcs
    assert got["counters"]["layout_hits"] >= 1
    assert "layout_builds" not in got["counters"]


def test_missing_inputs_are_made_once_a_graph(stencil):
    """Two calls with colors=None colour the graph once, build one ordered
    system and give the same x."""
    cfg, edges, _, ref, x0 = stencil
    g = run.build_graph(edges, cfg)             # a fresh cache
    b = reference_symgs.rhs(ref, DIAG, OFF).numpy().astype(np.float32)
    Ax = np.full(g.nnz, OFF, np.float32)
    diag = np.full(g.m, DIAG, np.float32)
    P.take()
    with P.recording():
        a = tsymgs.symgs_solver(g, Ax, x0.numpy(), b, diag, device="cpu")
        c = tsymgs.symgs_solver(g, Ax, x0.numpy(), b, diag, device="cpu")
    got = P.take()
    assert len(spans(got, "solve.vc")) == 1
    assert len(spans(got, "layout.symgs")) == 1
    assert len(spans(got, "layout.symgs_inputs")) == 1
    assert torch.equal(a.x, c.x) and a.num_colors == c.num_colors
    assert sum(k[1] == "symgs" for k in g._device_cache) == 1


def test_the_filled_inputs_keep_their_draws():
    """What is filled is drawn from default_rng(13) in the order Ax, x, b,
    each only when missing, as before it was cached."""
    cfg = hpcg20(6)
    g = run.build_graph(generators.generate(cfg, 1, "cpu"), cfg)
    Ax = np.full(g.nnz, OFF, np.float32)
    got = tsymgs.fill_inputs(g, Ax, None, None, None, np.zeros(g.m, np.int32),
                             device="cpu")
    rng = np.random.default_rng(13)
    assert got[0] is Ax
    np.testing.assert_array_equal(got[1], rng.random(g.m).astype(np.float32))
    np.testing.assert_array_equal(got[2], rng.random(g.m).astype(np.float32))
    np.testing.assert_array_equal(got[3], (g.degrees + 1).astype(np.float32))
    again = tsymgs.fill_inputs(g, Ax, None, None, None,
                               np.zeros(g.m, np.int32), device="cpu")
    assert all(p is q for p, q in zip(got[:4], again[:4]))
    every = tsymgs.fill_inputs(g, device="cpu")
    rng = np.random.default_rng(13)
    np.testing.assert_array_equal(every[0],
                                  rng.random(g.nnz).astype(np.float32))
    assert every[1] is not got[1]
    assert all(p is q for p, q in zip(every, tsymgs.fill_inputs(
        g, device="cpu")))


def test_the_reference_imports_nothing_of_the_port_or_jax():
    import ast
    tree = ast.parse(open(reference_symgs.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names == {"__future__", "torch"}
    code = (
        "import json, sys, torch\n"
        "from graphbench import reference, reference_symgs, generators\n"
        "e = generators.generate({'generator': 'stencil27', 'scale': 6},"
        " 1, 'cpu')\n"
        "g = reference.clean_csr(e.m, e.src, e.dst)\n"
        "b = reference_symgs.rhs(g, 26.0, -1.0)\n"
        "reference_symgs.symgs(g, torch.zeros(g.m), b,"
        " torch.zeros(g.m, dtype=torch.int64), diagonal=26.0,"
        " off_diagonal=-1.0)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=manifest.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "gardenia_tpu",
                       "gardenia_tpu_torch"}
