"""The port's training data loader (coordinator, RoIDataLoader) against the
JAX package's on the synthetic dataset of tests/fixtures.py.

With one thread the loader's stream is bitwise the JAX loader's: the same
entries in the same order over two epochs, with aspect grouping and
bagging-mixup on, and the same draws (scale, jitter, crop, mixup coin,
partner, lambda). Every blob but the image is compared exactly; the image
differs by the resize (cv2 against torch) within 2e-2 with the HSV jitter
off, and only its shape is compared with the jitter on (it is held against
cv2 on its own in test_torch_train.py). ``im_hw`` is the image's own
extent in the port and the bucket-padded canvas in the JAX package.
"""

import os
import queue
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import fixtures
from nafwebsod_tpu.core import config as jax_config
from nafwebsod_tpu.data import catalog as jax_catalog
from nafwebsod_tpu.data import loader as jax_loader
from nafwebsod_tpu.data import roidb as jax_roidb
from nafwebsod_tpu.utils import coordinator as jax_coordinator
from nafwebsod_torch.core import config as port_config
from nafwebsod_torch.data import catalog, loader
from nafwebsod_torch.data import roidb as roidb_lib
from nafwebsod_torch.utils import coordinator


@pytest.fixture(autouse=True)
def _fresh_cfgs():
    jax_config.reset_cfg()
    port_config.reset_cfg()
    yield
    jax_config.reset_cfg()
    port_config.reset_cfg()


def _configure(c, distortion=True):
    c.MODEL.NUM_CLASSES = len(fixtures.CLASSES) + 1
    c.TRAIN.SCALES = (48, 64, 80)
    c.TRAIN.MAX_SIZE = 120
    c.TRAIN.BATCH_SIZE_PER_IM = 20
    c.TRAIN.CROWD_FILTER_THRESH = 0.0
    c.TRAIN.USE_FLIPPED = True
    c.TRAIN.ASPECT_GROUPING = True
    c.TPU.ROI_PAD_MULTIPLE = 16
    c.TPU.SIZE_BUCKET_MULTIPLE = 32
    c.WSL.USE_DISTORTION = distortion
    c.WSL.USE_CROP = True
    c.WEBLY.WEBLY_ON = True
    c.WEBLY.BAGGING_MIXUP = True
    c.RNG_SEED = 7


def _roidbs(tmp_path, n_images=6):
    """The fixture dataset as both packages' training roidbs: landscape and
    portrait images, two of each class, flipped copies."""
    info = fixtures.make_coco_dataset(str(tmp_path), n_images=n_images,
                                      width=100, height=96)
    for cat in (catalog, jax_catalog):
        cat.register_dataset('synth_loader', info['image_dir'],
                             info['ann_file'])
    want = jax_roidb.combined_roidb_for_training(('synth_loader',),
                                                 (info['prop_file'],))
    got = roidb_lib.combined_roidb_for_training(('synth_loader',),
                                                (info['prop_file'],))
    return got, want


def test_coordinator_stops_on_a_failing_worker_and_its_queue_calls_give_up():
    for mod in (coordinator, jax_coordinator):
        coord = mod.Coordinator()
        q = queue.Queue(maxsize=1)
        mod.coordinated_put(coord, q, 'a')
        assert mod.coordinated_get(coord, q) == 'a'

        def worker():
            with coord.stop_on_exception():
                raise ValueError('boom')

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and coord.should_stop()
        with pytest.raises(Exception, match='stopped during get'):
            mod.coordinated_get(coord, q)
        q.put('b')
        with pytest.raises(Exception, match='stopped during put'):
            mod.coordinated_put(coord, q, 'c')


def _take(ldr, n):
    return [ldr.build_minibatch() for _ in range(n)]


@pytest.mark.parametrize('distortion', [True, False])
def test_one_thread_stream_is_bitwise_the_jax_loaders(tmp_path, distortion):
    for c in (jax_config.cfg, port_config.cfg):
        _configure(c, distortion)
    got_roidb, want_roidb = _roidbs(tmp_path)
    assert len(got_roidb) == 12
    landscape = [e['width'] >= e['height'] for e in got_roidb]
    assert 0 < sum(landscape) < len(landscape)
    pad_to = loader.pad_rois_to()
    np.random.seed(port_config.cfg.RNG_SEED)
    want_ldr = jax_loader.RoIDataLoader(want_roidb, num_loaders=1,
                                        pad_rois_to=pad_to, size_bucket=32)
    port_config.cfg.DATA_LOADER.NUM_THREADS = 1
    got_ldr = loader.RoIDataLoader(got_roidb)
    n = 2 * len(got_roidb)
    want = _take(want_ldr, n)
    got = _take(got_ldr, n)
    assert got_ldr._order == want_ldr._order     # the second epoch's
    mixed = 0
    for i, (g, w) in enumerate(zip(got, want)):
        mixed += g.pop('mixup', False)
        assert set(g) == set(w), i
        for k in w:
            if k in ('data', 'im_hw'):
                continue
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
        assert g['data'].shape == w['data'].shape, i
        if not distortion:
            np.testing.assert_allclose(g['data'], w['data'], atol=2e-2)
        # the port's im_hw is the image's extent; padded to the bucket it
        # is the JAX package's canvas
        np.testing.assert_array_equal(np.ceil(g['im_hw'] / 32) * 32,
                                      w['im_hw'])
        assert (g['im_hw'] <= g['data'].shape[1:3]).all()
    assert 0 < mixed < n
    # each epoch is a permutation, landscape images first
    for epoch in range(2):
        ids = [(b['data_ids'][0]) for b in got[epoch * 12:(epoch + 1) * 12]]
        assert sorted(ids) == sorted(e['id'] for e in got_roidb)


def test_the_class_map_is_built_once(tmp_path, monkeypatch):
    _configure(port_config.cfg, distortion=False)
    roidb, _ = _roidbs(tmp_path)
    calls = []
    real = loader._image_label
    monkeypatch.setattr(loader, '_image_label',
                        lambda e: calls.append(1) or real(e))
    ldr = loader.RoIDataLoader(roidb)
    assert len(calls) == len(roidb)
    assert ldr._class2idx == {1: [0, 3, 6, 9], 2: [1, 4, 7, 10],
                              3: [2, 5, 8, 11]}
    blobs = _take(ldr, 30)
    mixed = sum(b.get('mixup', False) for b in blobs)
    assert mixed > 0
    # one label lookup per blend (the entry's own class), no rescan
    assert len(calls) == len(roidb) + mixed


def test_four_threads_permute_each_epoch_and_shut_down(tmp_path,
                                                       monkeypatch):
    _configure(port_config.cfg, distortion=False)
    roidb, _ = _roidbs(tmp_path)
    drawn = []
    real = loader.RoIDataLoader._next_index

    def spy(self):
        idx = real(self)
        drawn.append(idx)
        return idx

    monkeypatch.setattr(loader.RoIDataLoader, '_next_index', spy)
    port_config.cfg.DATA_LOADER.NUM_THREADS = 4
    port_config.cfg.DATA_LOADER.MINIBATCH_QUEUE_SIZE = 8
    ldr = loader.RoIDataLoader(roidb)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ldr.start(prefill=True)
        assert ldr.queue_size() >= 4
        blobs = [ldr.get(timeout=60) for _ in range(3 * len(roidb))]
    finally:
        ldr.shutdown()
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ldr._threads)
    # the lock keeps the epoch cursor whole: every epoch a permutation
    for epoch in range(3):
        part = drawn[epoch * len(roidb):(epoch + 1) * len(roidb)]
        assert sorted(part) == list(range(len(roidb))), epoch
    pad_to = loader.pad_rois_to()
    for b in blobs:
        assert b['rois'].shape == (pad_to, 5)
        assert b['valid_mask'].shape == (pad_to,)
        assert b['data'].shape[1] % 32 == 0 and b['data'].shape[2] % 32 == 0
        assert b['labels_oh'].sum() == pytest.approx(1.0)
        assert np.isfinite(b['data']).all()
    with pytest.raises(RuntimeError, match='shut down'):
        ldr.get()


def test_a_failing_thread_stops_the_loader_and_get_raises(tmp_path,
                                                          monkeypatch):
    _configure(port_config.cfg, distortion=False)
    roidb, _ = _roidbs(tmp_path, n_images=3)
    real = loader.build_minibatch
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) > 2:
            raise ValueError('decode failed')
        return real(*args)

    monkeypatch.setattr(loader, 'build_minibatch', flaky)
    port_config.cfg.DATA_LOADER.NUM_THREADS = 1
    port_config.cfg.DATA_LOADER.MINIBATCH_QUEUE_SIZE = 8
    ldr = loader.RoIDataLoader(roidb)
    try:
        ldr.start(prefill=True)
        t0 = time.time()
        with pytest.raises(RuntimeError, match='thread failed') as err:
            for _ in range(5):
                ldr.get()
        assert isinstance(err.value.__cause__, ValueError)
        assert time.time() - t0 < 10
    finally:
        ldr.shutdown()
    assert not ldr._threads[0].is_alive()
    idle = loader.RoIDataLoader(roidb)     # never started
    with pytest.raises(queue.Empty):
        idle.get(timeout=0.2)
