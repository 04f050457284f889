"""The comparison that decides ``correct``: what the window's fits
returned against the plain reference run on the same operands.

Two numbers are compared, each against the limit the mix's file states:

- ``obj_gap``: the largest relative gap between a fit's objective trace
  (one value an outer iteration) and the reference's, over the iterations,
  or at the last iteration alone where the mix's ``objective`` says
  ``"last"``; a trace of another length, or a value that is not finite,
  reads inf;
- ``param_gap``: the largest relative gap ‖p − p_ref‖ / ‖p_ref‖ over the
  fit's parameters (w; B; C; U and V), in float64.

Every fit of the window whose input the sample holds has
its objective trace compared (fits over the same operands share one
reference run); the sampled fits also have their parameters compared.  A
fit fails when a number is over its limit; ``correct`` holds when no fit
failed.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass

import torch

from portbench import precision

NUMBERS = ("obj_gap", "param_gap")


def fit_key(fin: dict) -> str:
    """What makes one fit's input differ from another's (its tensors are
    drawn from these)."""
    return json.dumps({k: v for k, v in fin.items()
                       if not isinstance(v, torch.Tensor)}, sort_keys=True)


def obj_gap(objs, ref, last: bool = False) -> float:
    if len(objs) != len(ref) or not ref:
        return math.inf
    if not all(math.isfinite(v) for v in list(objs) + list(ref)):
        return math.inf
    pairs = list(zip(objs, ref))[-1:] if last else zip(objs, ref)
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in pairs)


def param_gap(params: dict, ref: dict) -> float:
    if set(params) != set(ref):
        return math.inf
    gap = 0.0
    for k, r in ref.items():
        p = params[k]
        if tuple(p.shape) != tuple(r.shape):
            return math.inf
        p64, r64 = p.detach().double(), r.detach().double().to(p.device)
        num = float(torch.linalg.vector_norm(p64 - r64))
        den = float(torch.linalg.vector_norm(r64))
        if not (math.isfinite(num) and math.isfinite(den)):
            return math.inf
        gap = max(gap, num / max(den, 1e-30))
    return gap


@dataclass
class Verdict:
    correct: bool
    failed: int
    checks: dict
    lines: list


def judge(items, traces: dict, ops: dict, cfg: dict, mix: dict,
          reference) -> Verdict:
    """``items``: the sampled fits, (index, input, parameters);
    ``traces``: every fit's objective trace by input key, [(index,
    trace)]."""
    limits = mix.get("limits") or {}
    last = mix.get("objective") == "last"
    worst = {n: 0.0 for n in NUMBERS}
    bad: set[int] = set()
    refs = {}
    with torch.no_grad():
        for i, fin, params in items:
            key = fit_key(fin)
            if key not in refs:
                refs[key] = reference.fit(ops, fin, cfg, precision.fp32_mm)
                for j, objs in traces.get(key, []):
                    g = obj_gap(objs, refs[key][1], last)
                    worst["obj_gap"] = max(worst["obj_gap"], g)
                    if not g <= _limit(limits, "obj_gap"):
                        bad.add(j)
            g = param_gap(params, refs[key][0])
            worst["param_gap"] = max(worst["param_gap"], g)
            if not g <= _limit(limits, "param_gap"):
                bad.add(i)
    checks = {n: {"value": worst[n], "limit": limits.get(n)}
              for n in NUMBERS}
    correct = bool(refs) and not bad and all(
        limits.get(n) is not None for n in NUMBERS)
    lines = [f"check {n} {worst[n]!r} limit {limits.get(n)!r}"
             for n in NUMBERS]
    return Verdict(correct, len(bad), checks, lines)


def _limit(limits: dict, name: str) -> float:
    v = limits.get(name)
    return -math.inf if v is None else v
