"""The port's SSSP on the benchmark's weighted kron (graphbench's kron20w
at small scales, on the CPU): every variant against the plain weighted
reference (graphbench/reference_sssp.py), the pair-weight rule on both
sides, the kron20-sssp cell's check, controls and readers, and the SSSP
loops' spans and counters (utils/profiler)."""

import numpy as np
import pytest
import torch

from gardenia_tpu_torch.solvers import sssp as tsssp
from gardenia_tpu_torch.solvers.sssp import INF, sssp_solver
from gardenia_tpu_torch.utils import profiler as P

from graphbench import generators, manifest, reference_sssp, run
from graphbench.kernels import sssp as ksssp


def kron20w(scale):
    cfg = dict(manifest.config(manifest.load_benchmark(), "kron20w"))
    cfg["scale"] = scale
    return cfg


@pytest.fixture(scope="module", params=[10, 12], ids=["kron10w", "kron12w"])
def weighted(request):
    """(cfg, raw edges, the port's Graph, the reference's graph, sources)
    of a seeded weighted kron."""
    cfg = kron20w(request.param)
    edges = generators.generate(cfg, 2**31 + request.param, "cpu")
    g = run.build_graph(edges, cfg)
    ref = reference_sssp.weighted_csr(edges.m, edges.src, edges.dst,
                                      edges.wt)
    pool = torch.nonzero(ref.degrees > 0).flatten().numpy()
    sources = np.random.default_rng(request.param).choice(pool, 3)
    return cfg, edges, g, ref, [int(s) for s in sources]


def as_ref(dist):
    d = dist.to(torch.int64)
    return torch.where(d >= INF, -1, d)


@pytest.mark.parametrize("variant,delta", [("delta", 1), ("delta", 16),
                                           ("hybrid", 16), ("bf", 1),
                                           ("nearfar", 16)])
def test_port_matches_the_weighted_reference(weighted, variant, delta):
    _, _, g, ref, sources = weighted
    for s in sources:
        got = sssp_solver(g, s, delta, variant=variant, device="cpu")
        want, _ = reference_sssp.distances(ref, s)
        assert got.dist.dtype == torch.int32
        assert torch.equal(as_ref(got.dist), want)
        assert int(want.max()) > 256      # past bfloat16's exact integers


def test_the_pair_weight_is_the_least_over_both_directions():
    # (0, 1): 7 and 3 one way, 5 the other -> 3; (1, 2): 9 and 4 -> 4;
    # (2, 3): 6 once; a self-loop (3, 3) is dropped
    src = torch.tensor([0, 0, 1, 1, 2, 2, 3], dtype=torch.int32)
    dst = torch.tensor([1, 1, 0, 2, 1, 3, 3], dtype=torch.int32)
    wt = torch.tensor([7, 3, 5, 9, 4, 6, 1], dtype=torch.float64)
    edges = generators.Edges(4, src, dst, wt)
    want = {(0, 1): 3, (1, 0): 3, (1, 2): 4, (2, 1): 4, (2, 3): 6,
            (3, 2): 6}
    ref = reference_sssp.weighted_csr(4, src, dst, wt)
    assert {(int(u), int(v)): int(w) for u, v, w in
            zip(ref.rows, ref.cols, ref.weights)} == want
    g = run.build_graph(edges, kron20w(2))
    rows = np.repeat(np.arange(4), np.diff(np.asarray(g.rowptr)))
    assert {(int(u), int(v)): int(w) for u, v, w in
            zip(rows, g.colidx, g.weights)} == want
    for variant in ("delta", "nearfar"):
        got = sssp_solver(g, 0, 1, variant=variant, device="cpu")
        assert got.dist.tolist() == [0, 3, 7, 13]


def cell_run(weighted):
    """The check's inputs as the kron20-sssp cell makes them: the plan
    and three trials' answers."""
    cfg, edges, g, _, _ = weighted
    mix = manifest.mix("sssp-random")
    plan = ksssp.plan(edges, cfg, mix, 2**31 + 3)
    trials = ksssp.Trials(g, torch.device("cpu"), mix, plan)
    return cfg, mix, plan, [(i, trials(i)) for i in range(3)]


def test_check_reads_zero_on_the_programs_answers(weighted):
    cfg, mix, plan, outputs = cell_run(weighted)
    got = ksssp.check(outputs, None, cfg, mix, plan)
    assert got["numbers"] == [("dist_mismatch", 0, 0)]
    assert got["failed"] == 0
    info = got["info"]
    its = [o[2] for _, o in outputs]
    assert info["sources_checked"] == 3 and info["answers_wrong"] == 0
    assert info["rounds_mean"] == pytest.approx(sum(its) / 3)
    assert (info["rounds_min"], info["rounds_max"]) == (min(its), max(its))
    assert 0 < info["reached_arcs"] <= plan["edges"][1].numel() * 2
    assert info["largest_distance"] > 256


@pytest.mark.parametrize("name", ksssp.CONTROLS)
def test_each_control_reads_a_mismatch(weighted, name, monkeypatch):
    cfg, mix, plan, outputs = cell_run(weighted)
    monkeypatch.setattr(ksssp, "CONTROLS", (name,))
    answers = ksssp.control(None, cfg, mix, plan, outputs)
    assert len(answers) == len(outputs)
    got = ksssp.check(answers, None, cfg, mix, plan)
    assert got["numbers"][0][1] > 0
    assert got["failed"] == len(outputs)
    assert "rounds_mean" not in got["info"]


def test_one_altered_distance_reads_a_mismatch(weighted):
    cfg, mix, plan, outputs = cell_run(weighted)
    i, (source, dist, it) = outputs[1]
    dist = dist.clone()
    v = int(torch.nonzero((dist > 0) & (dist < INF))[0])
    dist[v] += 1
    outputs[1] = (i, (source, dist, it))
    got = ksssp.check(outputs, None, cfg, mix, plan)
    assert got["numbers"][0][1] == 1 and got["failed"] == 1


def read(metric, run_):
    return manifest.metric(metric).read(run_)


def test_the_readers_on_a_hand_made_run():
    run_ = {"trace": {"busy_s": 0.5, "trials": 10, "window_s": 5.0},
            "peaks": {"hbm_bytes_per_s": 1e9},
            "graph": {"vertices": 1000},
            "reference": {"reached_arcs": 20000.0, "rounds_mean": 61.5}}
    # (8 B x 20,000 + 8 B x 1,000) / 1e9 B/s = 168 us of 50 ms busy
    assert read("sssp_roofline_pct", run_) == pytest.approx(0.336)
    assert read("sssp_rounds_per_trial", run_) == 61.5
    assert read("sssp_roofline_pct", dict(run_, trace=None)) is None
    assert read("sssp_roofline_pct", dict(run_, peaks=None)) is None
    assert read("sssp_roofline_pct", dict(run_, reference={})) is None
    assert read("sssp_rounds_per_trial", dict(run_, reference={})) is None


def counts(got, name):
    return sum(1 for s in got["spans"] if s[2] == name)


@pytest.mark.parametrize("alpha", [tsssp.ALPHA, 10**6],
                         ids=["as_is", "every_round_dense"])
def test_the_round_loop_records_one_read_a_round(weighted, alpha,
                                                 monkeypatch):
    _, _, g, _, sources = weighted
    monkeypatch.setattr(tsssp, "ALPHA", alpha)
    scouts = []
    sparse = tsssp.Relaxer.sparse

    def spy(self, dist, active, n_active, scout):
        scouts.append(scout)
        assert n_active == int(active.sum())
        return sparse(self, dist, active, n_active, scout)
    monkeypatch.setattr(tsssp.Relaxer, "sparse", spy)
    P.take()
    with P.recording():
        r = sssp_solver(g, sources[0], 16, device="cpu")
    got = P.take()
    c = got["counters"]
    dense = c.get("sssp.rounds_dense", 0)
    assert counts(got, "solve.sssp") == 1
    # the last round's read finds the frontier empty
    assert counts(got, "sssp.round") == c["host_reads"] == \
        r.iterations + 1 == counts(got, "read")
    assert c.get("sssp.rounds_sparse", 0) + dense == r.iterations
    assert c.get("sssp.rounds_sparse", 0) == len(scouts)
    assert c.get("sssp.edges_sparse", 0) == sum(scouts)
    if alpha == 10**6:          # threshold 0: a round with edges is dense
        assert dense > 0 and len(scouts) == 0


def test_the_near_far_loop_reads_through_the_recorder(weighted):
    _, _, g, _, sources = weighted
    P.take()
    with P.recording():
        r = sssp_solver(g, sources[0], 16, variant="nearfar", device="cpu")
    got = P.take()
    assert counts(got, "sssp.round") == r.iterations
    assert 0 < got["counters"]["host_reads"] == counts(got, "read") \
        <= r.iterations


def test_the_reference_imports_nothing_of_the_port_or_jax():
    import ast
    tree = ast.parse(open(reference_sssp.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names == {"__future__", "dataclasses", "torch"}
