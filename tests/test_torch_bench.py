"""The port's bench (coin_tpu_torch.tools.bench) on the CPU: its weighting
of the flavours against bench.py's own formulas, its reduction of the
repeated calls, the order of its alternating rounds, and its refusal to
run without a card. No flavour runs here: they need the card.
"""

import ast
import os

import pytest
import torch

import bench as jbench
from coin_tpu_torch.tools import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_py_formulas():
    """``eff_refresh`` and ``sched`` as bench.py defines them inside its
    ``main`` (bench.py:413-428), with the constants they read there."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    wanted = []
    for node in main.body:
        if isinstance(node, ast.FunctionDef) and node.name in (
                "eff_refresh", "sched"):
            wanted.append(node)
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") in ("REFRESH_EPOCHS", "img_one",
                                         "img_two") for t in node.targets):
            wanted.append(node)
    assert len(wanted) == 5, [ast.dump(n)[:40] for n in wanted]
    ns = {"BURN_UP": jbench.BURN_UP, "MAX_ITER": jbench.MAX_ITER}
    exec(compile(ast.Module(body=wanted, type_ignores=[]), "bench.py",
                 "exec"), ns)
    return ns


@pytest.mark.parametrize("rates", [
    dict(cached_i8=21.5, cached_two_i8=17.25, collect_i8=48.0, cached=25.0,
         cached_two=23.0, live=17.5, collect=52.0),
    dict(cached_i8=9.0, cached_two_i8=11.0, collect_i8=3.5, cached=12.0,
         cached_two=8.0, live=4.0, collect=6.0)])
def test_weighting_follows_bench_py(rates):
    ns = _bench_py_formulas()
    assert (bench.BURN_UP, bench.MAX_ITER, bench.REFRESH_EPOCHS) == (
        jbench.BURN_UP, jbench.MAX_ITER, ns["REFRESH_EPOCHS"])
    sched, eff = ns["sched"], ns["eff_refresh"]
    for a, b in ((rates["cached"], rates["live"]), (3.0, 7.0)):
        assert bench.sched(a, b) == pytest.approx(sched(a, b), rel=1e-12)
    assert bench.eff_refresh(rates["collect"], rates["cached_two"]) == \
        pytest.approx(eff(rates["collect"], rates["cached_two"]), rel=1e-12)
    h = bench.headline(rates)
    # the shipped recipe: int8 steps + int8 collection (bench.py:473-476)
    assert h["value"] == pytest.approx(sched(
        rates["cached_i8"], eff(rates["collect_i8"], rates["cached_two_i8"])),
        rel=1e-12)
    assert h["parity_recipe"] == pytest.approx(
        sched(rates["cached"], rates["live"]), rel=1e-12)
    assert h["weighted_refresh"] == pytest.approx(sched(
        rates["cached"], eff(rates["collect"], rates["cached_two"])),
        rel=1e-12)
    assert bench.headline({k: v for k, v in rates.items()
                           if k != "collect_i8"})["value"] is None


def test_summary_and_alternating_rounds(monkeypatch):
    assert bench.summarize([5.0, 1.0, 3.0, 9.0]) == {
        "median_ms": 4.0, "min_ms": 1.0, "max_ms": 9.0, "n": 4}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    order = []
    calls = {"a": lambda: order.append("a"), "b": lambda: order.append("b")}
    times = bench.time_flavours(calls, 3, "cpu", alternate=True)
    assert order == ["a", "b"] + ["a", "b", "b", "a", "a", "b"]
    assert {k: len(v) for k, v in times.items()} == {"a": 3, "b": 3}
    order.clear()
    bench.time_flavours(calls, 2, "cpu")
    assert order == ["a", "b", "a", "a", "b", "b"]


def test_bench_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--only", "eval"])
    with pytest.raises(SystemExit):
        bench.main(["--repeats", "3"])
