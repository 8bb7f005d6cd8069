"""An A/B artifact of the port's harness against a record of the same
campaign (an artifact of ``tools/validate_cached_teacher.py``): per arm and
endpoint, the two sets of functional seeds compared by Welch's two-sided
t-test.

    python -m coin_tpu_torch.tools.ab_compare PORT.json RECORD.json

Prints one JSON object: for the pre-train AP50 and each arm's avg3 and
final AP50, both sides' n, mean and standard deviation, Welch's t, its
degrees of freedom and p, ``matches`` (p >= 0.05) and the guide interval
of the port's mean, record mean +- 2.2 sd sqrt(1/n + 1/n_record); then
the port's own paired avg3 delta with its CI95 and the harness's verdict,
each arm's mean seconds, and ``all_match``.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, Sequence

import numpy as np

ALPHA = 0.05


def _betacf(a: float, b: float, x: float) -> float:
    """The continued fraction of the regularised incomplete beta
    function (modified Lentz)."""
    tiny, eps = 1e-300, 1e-15
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c, d = 1.0, 1.0 - qab * x / qap
    d = 1.0 / (d if abs(d) > tiny else tiny)
    h = d
    for m in range(1, 1000):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = 1.0 / (d if abs(d) > tiny else tiny)
        c = 1.0 + aa / c
        c = c if abs(c) > tiny else tiny
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = 1.0 / (d if abs(d) > tiny else tiny)
        c = 1.0 + aa / c
        c = c if abs(c) > tiny else tiny
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < eps:
            break
    return h


def betainc(a: float, b: float, x: float) -> float:
    """The regularised incomplete beta function I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    lbeta = math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
    front = math.exp(lbeta + a * math.log(x) + b * math.log1p(-x))
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1.0 - x) / b


def welch(a: Sequence[float], b: Sequence[float]) -> Dict[str, float]:
    """Welch's two-sided t-test of the means of ``a`` and ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    va, vb = a.var(ddof=1) / len(a), b.var(ddof=1) / len(b)
    t = (a.mean() - b.mean()) / math.sqrt(va + vb)
    df = (va + vb) ** 2 / (va ** 2 / (len(a) - 1) + vb ** 2 / (len(b) - 1))
    p = betainc(df / 2.0, 0.5, df / (df + t * t))
    return {"t": float(t), "df": float(df), "p": float(p)}


def _endpoints(artifact) -> Dict[str, list]:
    rows = [r for r in artifact["per_seed"] if not r["excluded"]]
    base, var = artifact["arms"]
    return {"pretrain_ap50": [r["pretrain_ap50"] for r in rows],
            f"{base}_avg3": [r["avg3_base"] for r in rows],
            f"{var}_avg3": [r["avg3_var"] for r in rows],
            f"{base}_final": [r["final_base"] for r in rows],
            f"{var}_final": [r["final_var"] for r in rows]}


def compare(port, record) -> dict:
    """The comparison that the module's docstring describes."""
    if (port["mode"], port["arms"]) != (record["mode"], record["arms"]):
        raise ValueError(f"the artifacts are of other campaigns: "
                         f"{port['mode']} {port['arms']} against "
                         f"{record['mode']} {record['arms']}")
    mine, theirs = _endpoints(port), _endpoints(record)
    out = {"mode": port["mode"], "fixture": port.get("fixture"),
           "platform": port.get("platform"), "endpoints": {}}
    for key, a in mine.items():
        b = theirs[key]
        half = 2.2 * float(np.std(b, ddof=1)) * math.sqrt(
            1.0 / len(a) + 1.0 / len(b))
        out["endpoints"][key] = dict(
            n=len(a), mean=float(np.mean(a)), sd=float(np.std(a, ddof=1)),
            per_seed=a, record_n=len(b), record_mean=float(np.mean(b)),
            record_sd=float(np.std(b, ddof=1)),
            guide=[float(np.mean(b)) - half, float(np.mean(b)) + half],
            **welch(a, b))
        out["endpoints"][key]["matches"] = \
            out["endpoints"][key]["p"] >= ALPHA
    rule = ("pretrain_ap50",) + tuple(f"{arm}_avg3" for arm in port["arms"])
    out["rule"] = (f"the port matches the record iff Welch's two-sided "
                   f"p >= {ALPHA} on each of {list(rule)}")
    out["all_match"] = all(out["endpoints"][k]["matches"] for k in rule)
    for k in ("delta_avg3_mean", "delta_avg3_ci95", "verdict",
              "n_functional", "excluded_seeds"):
        out[k] = port.get(k)
    rows = port["per_seed"]
    out["seconds"] = {arm: float(np.mean([r[f"{arm}_seconds"]
                                          for r in rows]))
                      for arm in port["arms"]}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("port", help="the port's artifact (or .partial)")
    p.add_argument("record", help="the record's artifact")
    args = p.parse_args(argv)
    with open(args.port) as f:
        port = json.load(f)
    with open(args.record) as f:
        record = json.load(f)
    out = compare(port, record)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
