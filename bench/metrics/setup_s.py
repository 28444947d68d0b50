"""Seconds of set-up: building or loading the kernels, the weights, the
tables, the engine and one warm pass of the mix."""


def read(run):
    return run["setup_s"]
