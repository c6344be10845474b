"""Process start → the first timed step: building or loading the kernels,
the weights, the engine and its plan, the caches, the warm-up of the
cell's shapes and of its traffic."""


def read(run):
    return run.setup_s
