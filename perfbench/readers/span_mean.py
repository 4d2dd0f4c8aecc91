"""Mean milliseconds of a span (``span``) recorded in the traced window."""


def read(data, spec):
    xs = [(b - a) / 1e6 for a, b in data.get("spans", {}).get(spec["span"], [])]
    return sum(xs) / len(xs) if xs else None
