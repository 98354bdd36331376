"""The share of a kernel's roofline in the traced rounds: the sum of each
launch's bound (bench/costs, at the cell's launch shapes) over the sum of
the device time of the kernel's device functions. Nothing is returned
where the trace holds another number of launches than the cell makes."""
from __future__ import annotations

import re
import sys

from bench.costs.peaks import bound_s


def share(ctx, kernel: str, family: str, primary: str) -> float | None:
    tr, plan = ctx.trace, ctx.launches.get(kernel)
    if tr is None or not plan:
        return None
    ops = [op for op in tr.ops if re.search(family, op.name)]
    n = sum(1 for op in ops if re.search(primary, op.name))
    want = len(plan) * tr.rounds
    counted = ctx.counts.get(kernel)
    if n != want or (counted is not None and counted != want):
        print(f"[bench] {kernel}: {n} launches traced, {counted} counted, "
              f"{want} expected: no roofline", file=sys.stderr)
        return None
    seconds = sum(op.end - op.start for op in ops) * 1e-6
    if seconds <= 0:
        return None
    bound = sum(bound_s(o, b, dt) for o, b, dt in plan) * tr.rounds
    return 100.0 * bound / seconds
