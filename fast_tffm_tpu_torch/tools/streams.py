"""The stream readers' argument policy — a copy of the JAX package's
``tools.expand_stream_args``, shared by the port's ``fmstat`` and
``fmtrace`` so that their glob sorting and missing-file behaviour stay
one."""

from typing import List, Sequence


def expand_stream_args(paths: Sequence[str]) -> List[str]:
    """Glob-expand metrics-file CLI args and fail loudly on unreadable
    inputs. read_events itself tolerates only torn final lines; a
    typo'd path must error, not summarize zero events."""
    import glob as globlib

    from fast_tffm_tpu_torch.obs.sink import read_events
    out: List[str] = []
    for p in paths:
        hits = sorted(globlib.glob(p))
        out.extend(hits if hits else [p])
    for f in out:
        next(iter(read_events(f)), None)
    return out
