"""lcc_phase_s: mean per search of the seconds on the ``LP`` rows of
``MatchResult.rows`` (the driver's host clock around each LCC call, ended by
a device read), over the searches the profiler did not slow down."""


def read(run):
    res = run.untraced()
    if not res:
        return None
    return sum(r.seconds for m in res for r in m.rows if r.phase == "LP") / len(res)
