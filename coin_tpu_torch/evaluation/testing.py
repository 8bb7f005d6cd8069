"""Result printing and expected-results verification (copy of
coin_tpu/evaluation/testing.py, a host module, kept so that the port
imports nothing of coin_tpu)."""

from __future__ import annotations

import logging
import sys
from typing import Dict

logger = logging.getLogger(__name__)


def print_csv_format(results: Dict[str, float]) -> str:
    """Markdown-ish metric table, returned and logged."""
    keys = [k for k in ("AP", "AP50", "AP75") if k in results]
    per_class = {k: v for k, v in results.items() if k.startswith("AP50-")}
    lines = ["| " + " | ".join(keys) + " |",
             "|" + "---|" * len(keys),
             "| " + " | ".join(f"{results[k]:.3f}" for k in keys) + " |"]
    if per_class:
        names = [k[len("AP50-"):] for k in per_class]
        lines += ["| " + " | ".join(names) + " |",
                  "|" + "---|" * len(names),
                  "| " + " | ".join(f"{v:.3f}"
                                    for v in per_class.values()) + " |"]
    table = "\n".join(lines)
    logger.info("\n%s", table)
    return table


def verify_results(expected, results: Dict[str, float]) -> bool:
    """expected: list of (metric_key, value, tolerance). Exits non-zero on
    a mismatch, as the reference does; True otherwise."""
    ok = True
    for key, value, tol in expected or []:
        actual = results.get(key)
        if actual is None or abs(actual - value) > tol:
            logger.error("verify_results: %s = %s, expected %s ± %s",
                         key, actual, value, tol)
            ok = False
    if not ok:
        sys.exit(1)
    return ok
