"""Set-up: process start to the first measured iteration (host clock)."""


def read(run):
    return run.setup_s
