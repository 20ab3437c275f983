"""Cooperative shutdown for the loader's worker threads (the port's own
copy of the JAX package's ``utils/coordinator.py``): a shared stop event,
an exception-capturing context, and 1-second polling queue access so that
parked threads notice a stop request. Worker failures report through
``logging``.
"""

import contextlib
import logging
import queue as _queue
import threading

logger = logging.getLogger(__name__)

_POLL_SECONDS = 1.0


class Coordinator:
    """A stop flag shared by every thread of one loader."""

    __slots__ = ('_stop',)

    def __init__(self):
        self._stop = threading.Event()

    def request_stop(self):
        if not self._stop.is_set():
            logger.debug('coordinator: stop requested')
        self._stop.set()

    def should_stop(self):
        return self._stop.is_set()

    @contextlib.contextmanager
    def stop_on_exception(self):
        """Convert an escaping exception into a stop request (the first
        failure logs its traceback; later ones stay quiet)."""
        try:
            yield
        except Exception:
            if not self.should_stop():
                logger.exception('coordinator: worker failed, stopping')
                self.request_stop()


def _poll(coordinator, verb, op):
    """Retry a blocking queue operation in short slices until it succeeds
    or the coordinator stops."""
    while not coordinator.should_stop():
        try:
            return op(_POLL_SECONDS)
        except (_queue.Empty, _queue.Full):
            pass
    raise Exception('Coordinator stopped during {}()'.format(verb))


def coordinated_get(coordinator, q):
    return _poll(coordinator, 'get',
                 lambda t: q.get(block=True, timeout=t))


def coordinated_put(coordinator, q, element):
    return _poll(coordinator, 'put',
                 lambda t: q.put(element, block=True, timeout=t))
