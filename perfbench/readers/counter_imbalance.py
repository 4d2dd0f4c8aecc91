"""The busiest slot of a counter over its mean, averaged over the
program's counters whose names start with ``prefix`` (one a layer, each
an array with a slot per held expert): 1 where the load is even. Read
from the program's registry (``counters``) in this process after the
driver returns; the counters run from the process's start. None where the
program keeps no counters, or none of that name took a count."""

import numpy as np

from . import program_span


def read(data, spec):
    reg = program_span.registry()
    counters = getattr(reg, "counters", None)
    if not callable(counters):
        return None
    loads = [np.asarray(v, np.float64) for v in counters(spec["prefix"]).values()]
    loads = [v for v in loads if v.size and v.sum() > 0]
    if not loads:
        return None
    return float(np.mean([v.max() / v.mean() for v in loads]))
