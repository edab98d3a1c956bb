"""The numbers that decide ``correct``, and their limits.

A training number is a gap of norms taken by the worst leaf: for each
leaf, the distance between the program's norm and the reference's,
over the reference's norm of that leaf or of the median leaf, whichever
is larger (some gradients are all but zero). Leaves whose reference
gradient at step 1 is under a thousandth of the median leaf's are left
out of the parameters' change: they move by round-off alone.

Each cell's limits are data: ``chipbench/limits/<workload>.json`` maps
each number's name to its limit (``limits``), lists the numbers that are
read but not compared (``not_compared``: no control or fault separates
them from sound runs), and records the readings each limit was set from.
A number with neither a limit nor a place in ``not_compared`` fails.
"""
from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict, Iterable, List, Optional

import torch


def leaf_norms(flat: Dict[str, torch.Tensor], scale: float = 1.0):
    return {k: float(torch.linalg.vector_norm(v.float())) * scale
            for k, v in flat.items()}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             skip: Iterable[str] = ()) -> float:
    skip = set(skip)
    med = statistics.median(ref.values())
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if k not in skip]
    return max(gaps) if gaps else 0.0


def still_leaves(graw1: Dict[str, float]) -> List[str]:
    """Leaves whose step-1 reference gradient is under a thousandth of
    the median leaf's."""
    med = statistics.median(graw1.values())
    return [k for k, v in graw1.items() if v < 1e-3 * med]


def loss_gap(prog: List[float], ref: List[float]) -> float:
    if len(prog) != len(ref) or not all(map(math.isfinite, prog)):
        return math.inf
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def load_limits(root: str, workload: str) -> dict:
    path = os.path.join(root, "chipbench", "limits", f"{workload}.json")
    if not os.path.exists(path):
        return {"limits": {}}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def judge(numbers: Dict[str, float], limits: dict
          ) -> Dict[str, Dict[str, Optional[float]]]:
    """{name: {"value", "limit"}} of the numbers compared; a missing
    limit is None and fails."""
    skip = set(limits.get("not_compared", ()))
    return {k: {"value": v, "limit": limits["limits"].get(k)}
            for k, v in numbers.items() if k not in skip}


def within(check) -> bool:
    return (check["limit"] is not None and math.isfinite(check["value"])
            and check["value"] <= check["limit"])


def passed(checks) -> bool:
    return bool(checks) and all(map(within, checks.values()))
