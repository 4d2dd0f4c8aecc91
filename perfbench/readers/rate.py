"""A count of the window divided by the window's seconds."""


def read(data, spec):
    n, s = data.get(spec["count"]), data.get(spec["seconds"])
    if n is None or not s:
        return None
    return n / s
