"""Share of the profiled sub-window, in %, in which no operation ran on
the device."""


def read(data, spec):
    prof = data.get("profile")
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.window_s)
