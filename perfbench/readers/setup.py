"""Set-up seconds: process start to the first timed request or step."""


def read(data, spec):
    return data.get("setup_s")
