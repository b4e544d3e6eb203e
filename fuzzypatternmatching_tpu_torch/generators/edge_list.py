"""Edge-list file ingest. The port's own copy of
``fuzzypatternmatching_tpu/generators/edge_list.py``.

Replaces parallel_edge_list_reader.hpp: files may have 2 columns
(``src dst``) or 3 (``src dst edge_data``) — the reference sniffs the column
count from the first file and broadcasts it
(parallel_edge_list_reader.hpp:184-198). ``undirected=True`` mirrors the
ingest driver's ``-u`` flag (src/ingest_edge_list.cpp) by emitting both
directions of every entry.
"""

from __future__ import annotations

import numpy as np


def read_edge_lists(
    paths: list[str], undirected: bool = False, use_native: bool = True
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Returns (src, dst, edge_data|None) as the concatenated directed
    stream in file order. Uses the native streaming parser when available
    (native/fpm_native.cpp fpm_read_edge_list); loadtxt otherwise."""
    from .. import native

    native_ok = use_native and native.available()
    srcs, dsts, datas = [], [], []
    has_data = None
    for path in paths:
        if native_ok:
            s, d, e = native.read_edge_file_native(path)
            if s.size == 0:
                continue
            if has_data is None:
                has_data = e is not None
            srcs.append(s)
            dsts.append(d)
            if has_data:
                datas.append(e)
            continue
        arr = np.loadtxt(path, dtype=np.int64, ndmin=2)
        if arr.size == 0:
            continue
        cols = arr.shape[1]
        if has_data is None:
            has_data = cols >= 3
        srcs.append(arr[:, 0])
        dsts.append(arr[:, 1])
        if has_data:
            datas.append(arr[:, 2])
    if not srcs:
        return (
            np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.int64),
            None,
        )
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    data = np.concatenate(datas) if has_data else None
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if data is not None:
            data = np.concatenate([data, data])
    return src, dst, data
