"""The ``json_stats:`` line protocol and the smoothed scalar windows of the
training statistics (the port's own copy of that part of the JAX
package's ``utils/logging_utils.py``). ``tools/visualize_learn.py`` reads
the lines.
"""

import json
import sys
from collections import deque


def _jsonable(value):
    """Coerce numpy scalars/arrays to plain Python for json.dumps."""
    item = getattr(value, 'item', None)
    if item is not None and getattr(value, 'ndim', 0) == 0:
        return item()
    tolist = getattr(value, 'tolist', None)
    if tolist is not None:
        return tolist()
    raise TypeError('{!r} is not JSON serializable'.format(value))


def log_json_stats(stats):
    line = json.dumps(stats, sort_keys=True, default=_jsonable)
    sys.stdout.write('json_stats: ' + line + '\n')
    sys.stdout.flush()


class SmoothedValue:
    """The median of a scalar series over its last ``window_size``
    values."""

    def __init__(self, window_size):
        self._window = deque(maxlen=window_size)

    def AddValue(self, value):
        self._window.append(float(value))

    def GetMedianValue(self):
        ordered = sorted(self._window)
        k = len(ordered)
        mid = k // 2
        if k == 0:
            return float('nan')
        if k % 2:
            return ordered[mid]
        return 0.5 * (ordered[mid - 1] + ordered[mid])
