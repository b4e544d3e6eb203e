"""idle_nlcc_device_s: device-idle seconds per traced search while the
innermost open span is the device NLCC's walk, ``fpm.nlcc.walk.device``,
or one of the walk's own spans inside it (``.prepare``, ``.expand``,
``.winners``, ``.out``: ``engine/nlcc_device.py``), the program's spans
placed on the profiler's clock (``benchmark/spans.py``). None where no
traced search placed a walk on the device."""

WALK = "fpm.nlcc.walk.device"


def read(run):
    from benchmark.spans import idle_split, placed

    searches = placed(run)
    if not searches or not any(s[0] == WALK for spans in searches for s in spans):
        return None
    _, by_span = idle_split(run)
    return sum(v for k, v in by_span.items() if k == WALK or k.startswith(WALK + "."))
