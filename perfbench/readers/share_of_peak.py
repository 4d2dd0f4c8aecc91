"""FLOPs over seconds at the card's peak rate, in %."""


def read(data, spec):
    flops, secs, peak = data.get(spec["flops"]), data.get(spec["seconds"]), data.get("peak_flops")
    if not flops or not secs or not peak:
        return None
    return 100.0 * flops / (secs * peak)
