"""Device milliseconds a step of the operations launched inside one of the
program's own spans (``span``): over the profiled window (``profile.t0``
to ``profile.t1``), the device time of every operation whose launch,
aligned to ``time.time_ns()``, falls inside a span of that name starting
in the window, divided by the spans of ``per`` (the step) starting there.
Launches are the CUDA runtime's calls of every thread, so kernels that
autograd's device thread launches count under the main thread's span
that waits for them. None where the run was not traced, the trace holds
no device operation, the window holds no step, or the registry dropped
a span the window may hold."""

from . import program_span


def read(data, spec):
    prof, reg = data.get("profile"), program_span.registry()
    if prof is None or reg is None or not prof.ops:
        return None
    steps = reg.spans(spec["per"], prof.t0, prof.t1)
    under = reg.spans(spec["span"], prof.t0, prof.t1)
    if not steps or under is None:
        return None
    ivs = [(s.start_ns, s.end_ns) for s in under]
    total = sum(end - start for start, end, _, launch in prof.ops
                if launch is not None and any(a <= launch <= b for a, b in ivs))
    return total / len(steps) / 1e6
