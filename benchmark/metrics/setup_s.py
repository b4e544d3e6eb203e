"""setup_s: from the start of the run to the end of the warm-up search:
CUDA start, kernel load (a build where the checkout has none yet), the
graph, the engine's build and the warm-up."""


def read(run):
    return run.setup_s
