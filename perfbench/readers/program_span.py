"""Mean milliseconds a step of one of the program's own spans, read from
its span registry (``rag_icd10_tpu_torch.utils.metrics.metrics``) in
this process after the driver returns. ``stat`` ``mean``: the span's
length; ``self``: its length less the part its ``children`` (spans that
name it as their parent and share its id) cover.

The spans taken are those that start in the window the benchmark's own
spans cover (``data["spans"]``, recorded only in a traced run's window),
less any that holds the instant the profiler stopped (``profile.t1``):
the harness's time, not the program's. None where the run was not
traced, the program has no such registry, the window holds no such span,
or the registry dropped a span the window may hold."""

def registry():
    """The program's registry, or None where it has no ``spans``."""
    try:
        from rag_icd10_tpu_torch.utils import metrics as module
    except ImportError:
        return None
    reg = getattr(module, "metrics", None)
    return reg if callable(getattr(reg, "spans", None)) else None


def window(data):
    """(first start, last end) of the benchmark's own spans, or None."""
    ivs = [iv for ivs in data.get("spans", {}).values() for iv in ivs]
    if not ivs:
        return None
    return min(a for a, _ in ivs), max(b for _, b in ivs)


def self_ns(span, children):
    covered = sum(min(c.end_ns, span.end_ns) - max(c.start_ns, span.start_ns)
                  for c in children
                  if c.parent == span.name and c.id == span.id
                  and c.start_ns < span.end_ns and c.end_ns > span.start_ns)
    return span.end_ns - span.start_ns - covered


def read(data, spec):
    reg, win = registry(), window(data)
    if reg is None or win is None:
        return None
    spans = reg.spans(spec["span"], *win)
    if not spans:
        return None
    prof = data.get("profile")
    if prof is not None:
        spans = [s for s in spans if not s.start_ns <= prof.t1 <= s.end_ns]
    if not spans:
        return None
    if spec.get("stat", "mean") == "mean":
        xs = [s.end_ns - s.start_ns for s in spans]
    else:
        children = []
        for name in spec["children"]:
            got = reg.spans(name, win[0])
            if got is None:
                return None
            children += got
        xs = [self_ns(s, children) for s in spans]
    return sum(xs) / len(xs) / 1e6
