"""search_s: the whole window over the searches completed in it, the time
an analyst waits per search."""


def read(run):
    return run.window_s / len(run.times)
