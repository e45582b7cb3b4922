"""The generators repeat per seed and follow their sampling rules."""

import pytest
import torch

from graphbench import generators, manifest

KRON = {"generator": "kron", "scale": 10, "edge_factor": 16,
        "a": 0.57, "b": 0.19, "c": 0.19}
URAND = {"generator": "urand", "scale": 10, "edge_factor": 16}


@pytest.mark.parametrize("cfg", [KRON, URAND], ids=["kron", "urand"])
def test_same_seed_same_edges(cfg):
    e1 = generators.generate(cfg, 2**31 + 7, "cpu")
    e2 = generators.generate(cfg, 2**31 + 7, "cpu")
    e3 = generators.generate(cfg, 2**31 + 8, "cpu")
    assert e1.m == 1024 and e1.src.dtype == torch.int32
    assert len(e1.src) == 16 * 1024 and e1.wt is None
    assert torch.equal(e1.src, e2.src) and torch.equal(e1.dst, e2.dst)
    assert not torch.equal(e1.src, e3.src)
    assert int(e1.src.min()) >= 0 and int(e1.dst.max()) < e1.m


def test_kron_quadrants_follow_graph500_probabilities():
    gen = generators.device_generator(5, "cpu")
    n = 1 << 18
    src, dst = manifest.generator("kron").quadrants(1, n, 0.57, 0.19, 0.19,
                                                    gen, "cpu")
    share = {q: float(((src == q[0]) & (dst == q[1])).sum()) / n
             for q in [(0, 0), (0, 1), (1, 0), (1, 1)]}
    # 4 standard errors of a share near 0.5 at n = 2^18: 0.004
    assert share[(0, 0)] == pytest.approx(0.57, abs=0.004)
    assert share[(0, 1)] == pytest.approx(0.19, abs=0.004)
    assert share[(1, 0)] == pytest.approx(0.19, abs=0.004)
    assert share[(1, 1)] == pytest.approx(0.05, abs=0.004)


def test_kron_bits_are_independent_and_skewed():
    gen = generators.device_generator(9, "cpu")
    n = 1 << 16
    src, _ = manifest.generator("kron").quadrants(12, n, 0.57, 0.19, 0.19,
                                                  gen, "cpu")
    # each bit of the source is 1 with P(c or d) = 0.24
    for bit in (0, 5, 11):
        share = float(((src >> bit) & 1).sum()) / n
        assert share == pytest.approx(0.24, abs=0.01)


def test_kron_ids_are_permuted_and_urand_uniform():
    e = generators.generate(KRON, 3, "cpu")
    deg = torch.bincount(e.src.long(), minlength=e.m)
    # the hub is not vertex 0 once ids are permuted (P = 1 / 1024 by luck)
    assert int(deg.argmax()) != 0
    e = generators.generate(URAND, 3, "cpu")
    deg = torch.bincount(e.src.long(), minlength=e.m).float()
    assert float(deg.mean()) == 16.0 and float(deg.max()) < 40


def test_structure_seed_keeps_the_degrees_and_permutes_the_ids():
    cfg = dict(URAND, structure_seed=27491095)
    e1 = generators.generate(cfg, 11, "cpu")
    e2 = generators.generate(cfg, 12, "cpu")
    deg1 = torch.bincount(torch.cat([e1.src, e1.dst]).long(), minlength=e1.m)
    deg2 = torch.bincount(torch.cat([e2.src, e2.dst]).long(), minlength=e2.m)
    assert torch.equal(deg1.sort().values, deg2.sort().values)
    assert not torch.equal(e1.src, e2.src)
    e3 = generators.generate(cfg, 11, "cpu")
    assert torch.equal(e1.src, e3.src) and torch.equal(e1.dst, e3.dst)


@pytest.mark.parametrize("cfg", [KRON, URAND], ids=["kron", "urand"])
def test_weights_are_drawn_apart_from_the_edges(cfg):
    plain = generators.generate(cfg, 2**31 + 5, "cpu")
    weighted = generators.generate(dict(cfg, max_weight=255), 2**31 + 5,
                                   "cpu")
    assert torch.equal(plain.src, weighted.src)
    assert torch.equal(plain.dst, weighted.dst)
    wt = weighted.wt
    assert wt.dtype == torch.float64 and len(wt) == len(plain.src)
    assert float(wt.min()) == 1.0 and float(wt.max()) == 255.0
    assert torch.equal(wt, torch.round(wt))
    again = generators.generate(dict(cfg, max_weight=255), 2**31 + 5, "cpu")
    assert torch.equal(wt, again.wt)


def test_weights_reach_the_ports_graph():
    from graphbench.run import build_graph
    cfg = dict(KRON, scale=8, max_weight=255, symmetrize=True,
               remove_self_loops=True, dedup=True)
    g = build_graph(generators.generate(cfg, 21, "cpu"), cfg)
    assert g.weights is not None
    w = torch.as_tensor(g.weights)
    assert float(w.min()) >= 1.0 and float(w.max()) <= 255.0


def test_a_generator_is_found_by_name(tmp_path, monkeypatch):
    # a configuration's generator is a module of graphbench/generators/,
    # found by the name the configuration gives
    (tmp_path / "generators").mkdir()
    (tmp_path / "generators" / "ring.py").write_text(
        "import torch\n"
        "def edges(cfg, gen, device):\n"
        "    m = 1 << int(cfg['scale'])\n"
        "    s = torch.arange(m, dtype=torch.int32, device=device)\n"
        "    return s, (s + 1) % m\n")
    monkeypatch.setattr(manifest, "HERE", str(tmp_path))
    e = generators.generate({"generator": "ring", "scale": 4}, 1, "cpu")
    assert e.m == 16 and torch.equal(e.dst, (e.src + 1) % 16)
