"""The threaded training data loader (port of the JAX package's
``data/loader.py``): ``DATA_LOADER.NUM_THREADS`` threads build minibatches
into a bounded queue (``DATA_LOADER.MINIBATCH_QUEUE_SIZE``) that the
training loop drains, with coordinator-based shutdown.

  * a fresh permutation of the roidb every epoch; under
    ``TRAIN.ASPECT_GROUPING`` it is stably partitioned so that landscape
    images come before portrait ones;
  * bagging-mixup: with probability 0.2 a second image of the same class,
    from a class -> images map built once, is blended in with
    lambda ~ Beta(alpha, alpha).

Randomness: one ``np.random.RandomState(cfg.RNG_SEED)`` owned by the
loader and shared by its threads, drawn in the JAX package's order (the
permutation, then per minibatch the scale, ``get_minibatch``'s draws, the
mixup coin, the partner, the partner's ``get_minibatch`` and lambda). With
one thread the stream is therefore bitwise the JAX loader's after
``np.random.seed(cfg.RNG_SEED)``. With more threads the draws of
concurrent minibatches interleave in the order the threads reach them, so
the stream is not reproducible, as in the JAX package.
"""

import logging
import queue
import signal
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from nafwebsod_torch.core.config import cfg
from nafwebsod_torch.data.minibatch import (get_minibatch, mixup_blobs,
                                            pad_image_to_bucket)
from nafwebsod_torch.utils.coordinator import Coordinator, coordinated_put

logger = logging.getLogger(__name__)


def _image_label(entry):
    """First positive image-level class; mixup partners must share it."""
    gt = np.asarray(entry['gt_classes'])
    return int(gt[gt > 0][0])


def class_to_images(roidb):
    """{image-level class: indices of the roidb entries with it}."""
    by_class = defaultdict(list)
    for i, entry in enumerate(roidb):
        by_class[_image_label(entry)].append(i)
    return dict(by_class)


def pad_rois_to():
    """The RoI count of every training minibatch: BATCH_SIZE_PER_IM rounded
    up to TPU.ROI_PAD_MULTIPLE."""
    multiple = cfg.TPU.ROI_PAD_MULTIPLE
    return -(-cfg.TRAIN.BATCH_SIZE_PER_IM // multiple) * multiple


def build_minibatch(roidb, index, rng, class2idx):
    """The blobs of roidb entry ``index``, drawing from ``rng``. With
    WEBLY.BAGGING_MIXUP, with probability 0.2 a partner of the same class
    (from ``class2idx``, ``class_to_images(roidb)``; read only then) is
    blended in and the blobs carry ``'mixup': True``."""
    pad_to = pad_rois_to()
    size_bucket = cfg.TPU.SIZE_BUCKET_MULTIPLE
    entry = roidb[index]
    target_size = cfg.TRAIN.SCALES[rng.randint(0, len(cfg.TRAIN.SCALES))]
    blobs = get_minibatch(entry, rng=rng, pad_rois_to=pad_to,
                          size_bucket=size_bucket, target_size=target_size)
    if (cfg.WEBLY.WEBLY_ON and cfg.WEBLY.BAGGING_MIXUP
            and rng.random_sample() > 0.8):
        same_class = class2idx[_image_label(entry)]
        partner = roidb[same_class[rng.randint(len(same_class))]]
        blobs_b = get_minibatch(partner, rng=rng, pad_rois_to=pad_to,
                                size_bucket=size_bucket)
        lam = rng.beta(cfg.WEBLY.BAGGING_MIXUP_ALPHA,
                       cfg.WEBLY.BAGGING_MIXUP_ALPHA)
        blobs = mixup_blobs(blobs, blobs_b, lam, max_rois=pad_to)
        if size_bucket:
            blobs['data'] = pad_image_to_bucket(
                torch.from_numpy(blobs['data'][0]), size_bucket).numpy()[None]
        blobs['mixup'] = True
    return blobs


class RoIDataLoader:
    """Minibatches of ``roidb`` from DATA_LOADER.NUM_THREADS threads into
    a queue of DATA_LOADER.MINIBATCH_QUEUE_SIZE. ``start`` the threads,
    ``get`` each minibatch, and ``shutdown`` in a ``finally``: a loader
    thread that fails stops the loader, and ``get`` then raises with its
    error as the cause."""

    def __init__(self, roidb):
        self._roidb = roidb
        self._num_loaders = cfg.DATA_LOADER.NUM_THREADS
        self._minibatch_queue = queue.Queue(
            maxsize=cfg.DATA_LOADER.MINIBATCH_QUEUE_SIZE)
        self._rng = np.random.RandomState(cfg.RNG_SEED)
        self._lock = threading.Lock()
        self._order = []
        self._pos = 0
        self._failures = []
        self._threads = []
        self._previous_sigint = None
        self.coordinator = Coordinator()
        self._class2idx = (class_to_images(roidb) if cfg.WEBLY.WEBLY_ON
                           and cfg.WEBLY.BAGGING_MIXUP else None)
        self._begin_epoch()

    def build_minibatch(self):
        """The next minibatch of the stream (thread safe; the lock covers
        only the epoch cursor)."""
        return build_minibatch(self._roidb, self._next_index(), self._rng,
                               self._class2idx)

    def _begin_epoch(self):
        order = self._rng.permutation(len(self._roidb))
        if cfg.TRAIN.ASPECT_GROUPING:
            landscape = np.fromiter(
                (self._roidb[i]['width'] >= self._roidb[i]['height']
                 for i in order), dtype=bool, count=len(order))
            order = np.concatenate([order[landscape], order[~landscape]])
        self._order = [int(i) for i in order]
        self._pos = 0

    def _next_index(self):
        with self._lock:
            if self._pos >= len(self._order):
                self._begin_epoch()
            idx = self._order[self._pos]
            self._pos += 1
        return idx

    def _loader_thread(self):
        coord = self.coordinator
        with coord.stop_on_exception():
            try:
                while not coord.should_stop():
                    coordinated_put(coord, self._minibatch_queue,
                                    self.build_minibatch())
            except Exception as exc:
                if not coord.should_stop():   # a failure, not a shutdown
                    self._failures.append(exc)
                raise
        logger.debug('minibatch loader thread exiting')

    def start(self, prefill=False):
        """Start the threads; with ``prefill``, wait until the queue holds
        min(4, its capacity) minibatches or the loader stops."""
        for _ in range(self._num_loaders):
            t = threading.Thread(target=self._loader_thread, daemon=True)
            t.start()
            self._threads.append(t)
        if not prefill:
            return
        while self._minibatch_queue.qsize() < min(
                4, self._minibatch_queue.maxsize):
            if self.coordinator.should_stop():
                break
            time.sleep(0.01)

    def get(self, timeout=None):
        """Pop the next minibatch. Raises RuntimeError once the loader has
        stopped (the failing thread's error is the cause), and
        ``queue.Empty`` when ``timeout`` seconds pass without one."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.coordinator.should_stop():
            wait = 1.0
            if deadline is not None:
                wait = min(wait, deadline - time.monotonic())
                if wait <= 0:
                    raise queue.Empty(
                        'no minibatch within {:.0f} s'.format(timeout))
            try:
                return self._minibatch_queue.get(timeout=wait)
            except queue.Empty:
                pass
        cause = self._failures[0] if self._failures else None
        raise RuntimeError('the minibatch loader stopped: {}'.format(
            'a loader thread failed' if cause else 'it was shut down')
        ) from cause

    def queue_size(self):
        return self._minibatch_queue.qsize()

    def shutdown(self):
        """Stop and join the threads; restore the SIGINT handler that
        ``register_sigint_handler`` replaced."""
        self.coordinator.request_stop()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._previous_sigint is not None:
            signal.signal(signal.SIGINT, self._previous_sigint)
            self._previous_sigint = None

    def register_sigint_handler(self):
        """On SIGINT, shut the loader down (the training loop's ``get``
        then raises). Call from the main thread only."""
        def _on_sigint(signum, frame):
            logger.info('SIGINT: shutting down RoIDataLoader threads')
            self.coordinator.request_stop()
        self._previous_sigint = signal.signal(signal.SIGINT, _on_sigint)
