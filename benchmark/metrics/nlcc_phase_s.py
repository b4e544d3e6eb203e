"""nlcc_phase_s: mean per search of the seconds on the ``TP`` rows of
``MatchResult.rows`` (the driver's host clock around each constraint run),
over the searches the profiler did not slow down."""


def read(run):
    res = run.untraced()
    if not res:
        return None
    return sum(r.seconds for m in res for r in m.rows if r.phase == "TP") / len(res)
