"""The port's training job (``engine/train.py:train_model``, ``train_loop``,
the ``json_stats:`` lines, snapshots, AUTO_RESUME, the NaN guard, the
train CLI) against the JAX package's ``train_model`` on the synthetic
dataset of tests/fixtures.py, at a tiny width on the CPU.

Both packages start from the same pkl weights and draw the same data
stream (one loader thread, the loader's seed). Dropout is off in both: the
JAX package's ``models/heads.py:_dropout`` is patched to the identity in
this file, and the port's steps get no dropout generator. The images
differ by the resize (cv2 against torch) within 1.5e-2 pixel units before
the scaling to unit range (PIXEL_STDS). Four losses agree within rtol 1e-4, atol 1e-5 (the bound of
test_torch_train.py::test_three_train_steps_track_jax).
"""

import contextlib
import io
import json
import logging
import os
import signal
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import fixtures
from nafwebsod_tpu.core import config as jax_config
from nafwebsod_tpu.engine import train as jax_train
from nafwebsod_tpu.models import heads as jax_heads
from nafwebsod_torch.core import config as port_config
from nafwebsod_torch.data import catalog, minibatch
from nafwebsod_torch.engine import test_engine
from nafwebsod_torch.engine import train as train_engine
from nafwebsod_torch.models import detector
from nafwebsod_torch.parallel import train_step as ts
from nafwebsod_torch.utils import checkpoint
from nafwebsod_torch.utils.bridge import blob_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_cfgs():
    jax_config.reset_cfg()
    port_config.reset_cfg()
    yield
    jax_config.reset_cfg()
    port_config.reset_cfg()


def _tiny_train_cfg(c, info, output_dir):
    """tests/test_train.py's fixture cfg, in either package's cfg, with the
    pixels scaled to unit range (PIXEL_STDS 128): at the fixture's pixel
    scale the random head saturates the clamped CE, and a 1e-5 change of
    the input moves the loss by a percent."""
    fixtures.apply_tiny_webly_train_cfg(c, info, output_dir)
    c.PIXEL_STDS = np.array([[[128.0, 128.0, 128.0]]])
    catalog.register_dataset('synth_train', info['image_dir'],
                             info['ann_file'])


def _json_stats(text):
    return [json.loads(line[len('json_stats: '):])
            for line in text.splitlines() if line.startswith('json_stats: ')]


def _no_dropout(monkeypatch):
    monkeypatch.setattr(jax_heads, '_dropout',
                        lambda x, rate, rng, train: x)
    step = ts.train_step
    monkeypatch.setattr(
        train_engine.ts, 'train_step',
        lambda model, state, batch, lr, generator, **kw: step(
            model, state, batch, lr, None, **kw))


@pytest.fixture(scope='module')
def both_runs(tmp_path_factory):
    """One train_model run of each package on the same fixture, the same
    weights and the same stream: (jax checkpoints, losses, stats lines),
    (port checkpoints, records, stats lines)."""
    root = tmp_path_factory.mktemp('both')
    info = fixtures.make_coco_dataset(str(root / 'data'), n_images=4)
    jax_config.reset_cfg()
    port_config.reset_cfg()
    weights = str(root / 'weights.pkl')
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        _tiny_train_cfg(port_config.cfg, info, str(root / 'port'))
        checkpoint.save_weights_file(
            weights, test_engine.initialize_model_from_cfg(device='cpu'))
        port_config.cfg.TRAIN.WEIGHTS = weights
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = train_engine.train_model(device='cpu')
        out['port'] = got + (_json_stats(buf.getvalue()),)

        _tiny_train_cfg(jax_config.cfg, info, str(root / 'jax'))
        jax_config.cfg.TRAIN.WEIGHTS = weights
        np.random.seed(jax_config.cfg.RNG_SEED)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            want = jax_train.train_model()
        out['jax'] = want + (_json_stats(buf.getvalue()),)
    jax_config.reset_cfg()
    port_config.reset_cfg()
    return out


def test_four_losses_track_the_jax_train_model(both_runs):
    _, records, _ = both_runs['port']
    _, losses, _ = both_runs['jax']
    assert [r['iter'] for r in records] == [0, 1, 2, 3]
    assert len(losses) == 4
    np.testing.assert_allclose([r['loss'] for r in records], losses,
                               rtol=1e-4, atol=1e-5)


def test_snapshot_names_and_periods_equal_the_jax_packages(both_runs):
    got, _, _ = both_runs['port']
    want, _, _ = both_runs['jax']
    assert sorted(got, key=str) == sorted(want, key=str) == [1, 'final']
    for k in want:
        # <OUTPUT_DIR>/train/synth_train/generalized_wsl/<name>
        assert got[k].split(os.sep)[-4:] == want[k].split(os.sep)[-4:]
        assert os.path.isfile(got[k])
    blobs, saved_cfg = checkpoint.load_weights_pkl(got[1])
    assert 'fc8c_w' in blobs and 'fc8c_w_momentum' in blobs
    assert saved_cfg is not None


def test_json_stats_keys_equal_the_jax_packages(both_runs):
    _, _, got = both_runs['port']
    _, _, want = both_runs['jax']
    assert [s['iter'] for s in got] == [s['iter'] for s in want] == [0, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {'iter', 'lr', 'time', 'loss', 'eta', 'queue_size',
                'loss_cls', 'class_weight_mean'} <= set(g)
        assert 'mem' not in g        # the CPU has no device memory count


def _port_job(tmp_path, **overrides):
    info = fixtures.make_coco_dataset(str(tmp_path / 'data'), n_images=4)
    c = port_config.cfg
    _tiny_train_cfg(c, info, str(tmp_path / 'out'))
    for k, v in overrides.items():
        setattr(c.TRAIN, k, v)
    return c


def test_auto_resume_skips_a_finished_job_and_resumes_bitwise(tmp_path,
                                                             monkeypatch,
                                                             caplog):
    _port_job(tmp_path)
    checkpoints, records = train_engine.train_model(device='cpu')
    assert [r['iter'] for r in records] == [0, 1, 2, 3]
    with caplog.at_level(logging.INFO):
        again, none = train_engine.train_model(device='cpu')
    assert none == [] and again == {'final': checkpoints['final']}
    assert 'model_final.pkl exists; skipping training' in caplog.text

    os.remove(checkpoints['final'])
    started = {}
    loop = train_engine.train_loop

    def spy(model, solver, roidb, start_iter=0, *args, **kw):
        started['iter'] = start_iter
        started['weights'] = {k: v.clone()
                              for k, v in model.state_dict().items()}
        started['momentum'] = {k: v.clone()
                               for k, v in solver[2]['momentum'].items()}
        return loop(model, solver, roidb, start_iter, *args, **kw)

    monkeypatch.setattr(train_engine, 'train_loop', spy)
    resumed, more = train_engine.train_model(device='cpu')
    assert started['iter'] == 2 and [r['iter'] for r in more] == [2, 3]
    blobs, _ = checkpoint.load_weights_pkl(checkpoints[1])
    model = test_engine.initialize_model_from_cfg(device='cpu')
    names = blob_names(model)
    for key, name in names.items():
        np.testing.assert_array_equal(started['weights'][key].numpy(),
                                      blobs[name], err_msg=name)
        np.testing.assert_array_equal(started['momentum'][name].numpy(),
                                      blobs[name + '_momentum'],
                                      err_msg=name)
    assert blobs['fc8c_w_momentum'].any()
    assert os.path.isfile(resumed['final'])


def test_a_nan_loss_writes_the_state_before_it_and_raises(tmp_path,
                                                         monkeypatch):
    _port_job(tmp_path)
    forward = detector.Detector.forward_train

    def poisoned(self, batch, generator=None):
        total, aux = forward(self, batch, generator)
        if batch['cur_iter'] == 2:
            total = total * float('nan')
        return total, aux

    monkeypatch.setattr(detector.Detector, 'forward_train', poisoned)
    with pytest.raises(FloatingPointError, match='iter 2'):
        train_engine.train_model(device='cpu')
    out = port_config.get_output_dir(('synth_train',), training=True)
    assert not os.path.exists(os.path.join(out, 'model_final.pkl'))
    # the state after iteration 1, which model_iter1.pkl also holds
    nan, _ = checkpoint.load_weights_pkl(os.path.join(out, 'model_nan.pkl'))
    snap, _ = checkpoint.load_weights_pkl(
        os.path.join(out, 'model_iter1.pkl'))
    assert set(nan) == set(snap)
    for k in snap:
        np.testing.assert_array_equal(nan[k], snap[k], err_msg=k)
        assert np.isfinite(nan[k]).all(), k


def test_a_loader_thread_failure_stops_the_job(tmp_path, monkeypatch):
    """A minibatch that fails to build in a loader thread ends the job with
    an error on the main thread, its cause attached, and no final model."""
    from nafwebsod_torch.data import loader
    _port_job(tmp_path)
    real = loader.build_minibatch
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) > 3:
            raise OSError('unreadable image')
        return real(*args)

    monkeypatch.setattr(loader, 'build_minibatch', flaky)
    port_config.cfg.DATA_LOADER.MINIBATCH_QUEUE_SIZE = 2
    with pytest.raises(RuntimeError, match='loader thread failed') as err:
        train_engine.train_model(device='cpu')
    assert isinstance(err.value.__cause__, OSError)
    out = port_config.get_output_dir(('synth_train',), training=True)
    assert not os.path.exists(os.path.join(out, 'model_final.pkl'))


def test_the_train_cli_on_a_tiny_yaml(tmp_path, capsys, caplog):
    """tools/train_net_torch.py --cfg tiny.yaml --device cpu: the images are
    read with cv2, json_stats lines, snapshots, the final model and the
    snapshot tested on a dataset without a devkit (the COCO protocol); a
    second run skips training."""
    pytest.importorskip('yaml')
    import importlib.util
    info = fixtures.make_coco_dataset(str(tmp_path / 'test_data'),
                                      n_images=4, seed=1)
    catalog.register_dataset('synth_coco_test', info['image_dir'],
                             info['ann_file'])
    c = _port_job(tmp_path)
    c.TEST.DATASETS = ('synth_coco_test',)
    c.TEST.PROPOSAL_FILES = (info['prop_file'],)
    c.TEST.SCALE = 64
    c.TEST.MAX_SIZE = 120
    c.SOLVER.MAX_ITER = 3
    cfg_file = str(tmp_path / 'tiny.yaml')
    with open(cfg_file, 'w') as f:
        f.write(port_config.dump_cfg())
    port_config.reset_cfg()

    spec = importlib.util.spec_from_file_location(
        'train_net_torch', os.path.join(REPO, 'tools', 'train_net_torch.py'))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    handler = signal.getsignal(signal.SIGINT)
    checkpoints, records, results = tool.main(
        ['--cfg', cfg_file, '--device', 'cpu', 'OUTPUT_DIR',
         str(tmp_path / 'cli')])
    assert signal.getsignal(signal.SIGINT) is handler
    stats = _json_stats(capsys.readouterr().out)
    assert [s['iter'] for s in stats] == [0, 2]
    assert [r['iter'] for r in records] == [0, 1, 2]
    assert sorted(checkpoints, key=str) == [1, 'final']
    assert all(os.path.isfile(p) for p in checkpoints.values())
    assert sorted(results, key=str) == [1, 'final']
    for res in results.values():
        assert set(res) == {'synth_coco_test'}
        assert -1 <= res['synth_coco_test']['AP'] <= 1
    port_config.reset_cfg()
    with caplog.at_level(logging.INFO):
        again, none, tested = tool.main(
            ['--cfg', cfg_file, '--device', 'cpu', '--skip-test',
             'OUTPUT_DIR', str(tmp_path / 'cli')])
    assert none == [] and tested == {} and again == {
        'final': checkpoints['final']}
    assert 'skipping training' in caplog.text
    port_config.reset_cfg()
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch.cuda, 'is_available', lambda: False)
    try:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tool.main(['--cfg', cfg_file, 'OUTPUT_DIR',
                       str(tmp_path / 'card')])
    finally:
        monkey.undo()


def test_training_im_hw_is_the_images_extent_and_moves_the_rings(tmp_path):
    """get_minibatch records the image's own extent before the bucket
    padding (the JAX package records the padded canvas); mixup takes the
    larger of the two extents; the context head clips its rings there, so
    its loss differs from the one on the canvas's extent."""
    port_config.merge_cfg_from_cfg(port_config.CONTEXT)
    c = port_config.cfg
    c.MODEL.NUM_CLASSES = 5
    c.TPU.HEAD_HIDDEN_DIM = 8
    c.TPU.COMPUTE_DTYPE = 'float32'
    c.TRAIN.BATCH_SIZE_PER_IM = 24
    c.TRAIN.MAX_SIZE = 200
    c.WSL.USE_CROP = False
    c.WSL.USE_DISTORTION = False
    c.PIXEL_STDS = np.array([[[128.0, 128.0, 128.0]]])   # no saturation
    rng = np.random.RandomState(0)
    entries = []
    for h, w in ((60, 80), (70, 50)):
        boxes = np.array([[0, 0, w - 1, h - 1], [w - 30, h - 25, w - 1,
                                                 h - 1]] * 12, np.float32)
        entries.append({
            'image': rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            'boxes': boxes, 'obn_scores': rng.rand(24, 1).astype(np.float32),
            'gt_classes': np.array([2] + [0] * 23, np.int32)})
    a, b = [minibatch.get_minibatch(e, rng=rng, pad_rois_to=32,
                                    size_bucket=64, target_size=50)
            for e in entries]
    np.testing.assert_array_equal(a['im_hw'], [50, 67])
    assert a['data'].shape[1:3] == (64, 128)
    np.testing.assert_array_equal(b['im_hw'], [70, 50])
    mixed = minibatch.mixup_blobs(a, b, 0.4, max_rois=32)
    np.testing.assert_array_equal(mixed['im_hw'], [70, 67])
    assert mixed['data'].shape[1:3] == (128, 128)

    model = test_engine.initialize_model_from_cfg(device='cpu')
    batch = ts.to_device_batch(ts.stack_minibatches([a], 64), 'cpu')
    canvas = dict(batch, im_hw=torch.tensor([64.0, 128.0]))
    true_loss = model.forward_train(batch)[0].item()
    canvas_loss = model.forward_train(canvas)[0].item()
    assert np.isfinite(true_loss) and abs(true_loss - canvas_loss) > 1e-7
