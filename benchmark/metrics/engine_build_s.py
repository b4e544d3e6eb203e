"""engine_build_s: the harness's clock around the ``MatchEngine``
constructor in set-up (the host ELL build and its upload)."""


def read(run):
    return run.setup_parts.get("engine_build")
