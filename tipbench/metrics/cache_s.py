"""cache_s: host seconds of set-up's cached packing (the ``cache`` span:
``cached_trigraph``, its build on a miss).  Layer: host packing."""

from tipbench.lib import spans

PATTERNS = ()


def read(summary):
    return spans.total_s(spans.program_report(), "cache")
