"""setup_s: from the start of the process to the window's start (host
clock): imports, the genome, the index, the read pool, the engine's
load, and the warm-up stream."""


def read(run: dict):
    return run["setup_s"]
