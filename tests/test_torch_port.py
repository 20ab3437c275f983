"""Package-level properties of the PyTorch port: it stands alone (no JAX,
nothing of nafwebsod_tpu), its config matches the flagship YAML, and its
weights round-trip the reference pkl schema bitwise."""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nafwebsod_tpu.models import detector as jax_detector
from nafwebsod_tpu.utils import checkpoint as jax_ckpt
from nafwebsod_torch.core import config as port_config
from nafwebsod_torch.models import detector
from nafwebsod_torch.utils import checkpoint
from nafwebsod_torch.utils.bridge import blob_names, params_from_jax
from nafwebsod_torch.utils.io import load_object, save_object

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r'''
import importlib, pkgutil, sys
import nafwebsod_torch
names = [m.name for m in pkgutil.walk_packages(nafwebsod_torch.__path__,
                                               'nafwebsod_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'nafwebsod_tpu'))
print(len(names), bad)
'''


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(' ', 1)
    assert int(count) >= 46      # the training surface too
    assert bad.strip() == '[]', proc.stdout


def _imported_modules(*path):
    with open(os.path.join(REPO, *path)) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module)
    return imported


def test_chip_smoke_imports_nothing_of_jax():
    imported = _imported_modules('chip_smoke.py')
    assert 'nafwebsod_torch.ops' in imported
    assert 'nafwebsod_torch.engine' in imported
    assert not [m for m in imported
                if m.split('.')[0] in ('jax', 'jaxlib', 'nafwebsod_tpu')]


def test_the_test_cli_imports_nothing_of_jax():
    imported = _imported_modules('tools', 'test_net_torch.py')
    assert 'nafwebsod_torch.engine' in imported
    assert not [m for m in imported
                if m.split('.')[0] in ('jax', 'jaxlib', 'nafwebsod_tpu')]


def test_the_train_cli_imports_nothing_of_jax():
    imported = _imported_modules('tools', 'train_net_torch.py')
    assert 'nafwebsod_torch.engine' in imported
    assert not [m for m in imported
                if m.split('.')[0] in ('jax', 'jaxlib', 'nafwebsod_tpu')]


def test_chip_smoke_flagship_seed_blends_the_second_step():
    """chip_smoke.py's flagship training phase asserts that exactly its
    second step is a bagging-mixup blend; it draws through the loader with
    one thread, whose stream is host-only numpy from cfg.RNG_SEED, so the
    seed is held here."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from nafwebsod_torch.data.loader import RoIDataLoader
    port_config.reset_cfg()
    try:
        port_config.merge_cfg_from_cfg(port_config.FLAGSHIP)
        cfg = port_config.cfg
        cfg.RNG_SEED = chip_smoke.FLAGSHIP_TRAIN_SEED
        # smaller images: the draws do not depend on the scale
        cfg.TRAIN.SCALES = (96, 112, 128, 144, 160)
        roidb = chip_smoke.train_roidb(cfg.PIXEL_MEANS)
        cfg.DATA_LOADER.NUM_THREADS = 1
        loader = RoIDataLoader(roidb)
        blends = [bool(loader.build_minibatch().get('mixup', False))
                  for i in range(4)]
        assert blends == [False, True, False, False]
    finally:
        port_config.reset_cfg()


def test_every_training_module_is_behind_the_import_fence():
    """The fence above walks the package: the modules of the training
    surface and the COCO evaluator must be in it."""
    import pkgutil
    import nafwebsod_torch
    names = {m.name for m in pkgutil.walk_packages(nafwebsod_torch.__path__,
                                                   'nafwebsod_torch.')}
    for name in ('utils.coordinator', 'utils.logging_utils',
                 'utils.training_stats', 'data.loader', 'data.coco_evaluator',
                 'engine.train'):
        assert 'nafwebsod_torch.' + name in names, name
        imported = _imported_modules(*('nafwebsod_torch.' + name).split('.')[
            :-1], name.split('.')[-1] + '.py')
        assert not [m for m in imported if m and m.split('.')[0] in (
            'jax', 'jaxlib', 'nafwebsod_tpu', 'cv2', 'yaml')], name


def test_every_seg_module_is_behind_the_import_fence():
    """The fence above walks the package: the modules this family added
    must be in it (a module that is never imported is never checked)."""
    import pkgutil
    import nafwebsod_torch
    names = {m.name for m in pkgutil.walk_packages(nafwebsod_torch.__path__,
                                                   'nafwebsod_torch.')}
    for name in ('models.seg_head', 'ops.seg', 'ops.misc',
                 'ops.permutohedral', 'utils.segms'):
        assert 'nafwebsod_torch.' + name in names, name
        imported = _imported_modules(*('nafwebsod_torch.' + name).split('.')[
            :-1], name.split('.')[-1] + '.py')
        assert not [m for m in imported if m and m.split('.')[0] in (
            'jax', 'jaxlib', 'nafwebsod_tpu', 'cv2', 'yaml')], name
    assert os.path.isfile(os.path.join(
        REPO, 'nafwebsod_torch', 'ops', 'csrc', 'roi_align.cu'))


@pytest.mark.parametrize('mask_head', ['fcn', 'deeplab'])
def test_mask_entry_points_run_where_the_model_lives(mask_head,
                                                     monkeypatch):
    """``forward_masks``, ``forward_deeplab_masks`` and ``im_detect_mask``
    make their tensors on the model's device, and the model is built
    where ``utils.device.resolve_device`` says: the card, unless the
    caller passes ``device='cpu'``."""
    from nafwebsod_torch.engine import test as infer
    from nafwebsod_torch.engine import test_engine
    from nafwebsod_torch.utils import device as device_utils

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        device_utils.resolve_device(None)          # no card, no fallback
    assert device_utils.resolve_device('cpu') == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert device_utils.resolve_device(None).type == 'cuda'

    asked = []
    real = detector.resolve_device

    def spy(device=None):
        asked.append(device)
        return real('cpu')

    monkeypatch.setattr(detector, 'resolve_device', spy)
    port_config.reset_cfg()
    try:
        port_config.merge_cfg_from_cfg(
            port_config.SEG if mask_head == 'deeplab'
            else port_config.SEG_FCN)
        cfg = port_config.cfg
        cfg.MODEL.NUM_CLASSES = 5
        cfg.TPU.HEAD_HIDDEN_DIM = 8
        cfg.MRCNN.DIM_REDUCED = 8
        cfg.TPU.COMPUTE_DTYPE = 'float32'
        cfg.TEST.SCALE = 48
        cfg.TEST.MAX_SIZE = 64
        model = test_engine.initialize_model_from_cfg()   # as a user calls
        assert asked == [None]
        # a device the tensors must follow: the meta device computes
        # nothing, but refuses an operand that lives elsewhere
        model = model.to('meta')
        image = torch.zeros(1, 64, 64, 3, device='meta')
        if mask_head == 'fcn':
            monkeypatch.setattr(
                'nafwebsod_torch.ops.roi_pool.roi_align',
                lambda feat, rois, ph, pw, *a, **k: torch.zeros(
                    (rois.shape[0], ph, pw, feat.shape[2]),
                    device=feat.device))
            out = model.forward_masks(
                image, torch.zeros(3, 5, device='meta'))
            assert out.device.type == 'meta' and out.shape == (3, 28, 28, 5)
        else:
            out = model.forward_deeplab_masks(image)
            assert out.device.type == 'meta' and out.shape == (1, 7, 7, 5)
        # im_detect_mask builds the blob and the rois on model.device
        seen = []
        on_cpu = test_engine.initialize_model_from_cfg(device='cpu')
        assert asked[-1] == 'cpu'
        fn = ('forward_masks' if mask_head == 'fcn'
              else 'forward_deeplab_masks')
        real_fn = getattr(on_cpu, fn)

        def watch(*tensors):
            seen.extend(t.device for t in tensors)
            return real_fn(*tensors)

        monkeypatch.setattr(on_cpu, fn, watch)
        cls_boxes = [[]] + [np.array([[2, 3, 30, 40, 0.9]], np.float32)] * 4
        segms = infer.im_detect_mask(
            on_cpu, np.zeros((40, 50, 3), np.uint8), cls_boxes)
        assert [len(s) for s in segms] == [0, 1, 1, 1, 1]
        assert seen and all(d == on_cpu.device for d in seen)
    finally:
        port_config.reset_cfg()


def _same(a, b, key=''):
    assert type(a) is type(b), key
    if isinstance(a, dict):
        assert set(a) == set(b), key
        for k in a:
            _same(a[k], b[k], key + '.' + k)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=key)
        assert a.dtype == b.dtype, key
    else:
        assert a == b, key


def test_flagship_dict_equals_the_yaml():
    pytest.importorskip('yaml')
    port_config.reset_cfg()
    try:
        port_config.merge_cfg_from_file(os.path.join(
            REPO, 'configs', 'flickr_voc', 'na_wsddn_V-16-C5_1x.yaml'))
        from_yaml = dict(port_config.cfg)
        port_config.reset_cfg()
        port_config.merge_cfg_from_cfg(port_config.FLAGSHIP)
        _same(from_yaml, dict(port_config.cfg))
    finally:
        port_config.reset_cfg()


def test_csc_dict_equals_the_yaml():
    pytest.importorskip('yaml')
    port_config.reset_cfg()
    try:
        port_config.merge_cfg_from_file(os.path.join(
            REPO, 'configs', 'wsod_families', 'csc_V-16-C5.yaml'))
        from_yaml = dict(port_config.cfg)
        port_config.reset_cfg()
        port_config.merge_cfg_from_cfg(port_config.CSC)
        _same(from_yaml, dict(port_config.cfg))
    finally:
        port_config.reset_cfg()


def test_name_map_of_the_plain_head_covers_both_sides():
    kw = dict(num_classes=5, hidden_dim=8, box_head='vgg16_2fc',
              webly_on=False)
    params = jax_detector.init_params(jax_detector.ModelSpec(**kw),
                                      jax.random.PRNGKey(1))
    model = detector.build_model(detector.ModelSpec(**kw), device='cpu')
    names = blob_names(model)
    assert set(names) == set(model.state_dict())
    assert set(names.values()) == set(params)
    model.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}))


def _flagship_jax_params(hidden=8):
    spec = jax_detector.ModelSpec(num_classes=5, hidden_dim=hidden)
    params = jax_detector.init_params(spec, jax.random.PRNGKey(1))
    return {k: np.asarray(v) for k, v in params.items()}


def test_name_map_covers_both_sides():
    params = _flagship_jax_params()
    model = detector.build_model(
        detector.ModelSpec(num_classes=5, hidden_dim=8), device='cpu')
    names = blob_names()
    assert set(names) == set(model.state_dict())
    assert set(names.values()) == set(params)


def test_pkl_round_trip_is_bitwise(tmp_path):
    params = _flagship_jax_params()
    jax_pkl = str(tmp_path / 'jax.pkl')
    jax_ckpt.save_params_to_weights_file(jax_pkl, params)
    model = detector.build_model(
        detector.ModelSpec(num_classes=5, hidden_dim=8), device='cpu')
    assert checkpoint.initialize_from_weights_file(model, jax_pkl) == []
    bridged = params_from_jax(params)
    for key, value in model.state_dict().items():
        assert torch.equal(value, bridged[key]), key
    port_pkl = str(tmp_path / 'port.pkl')
    checkpoint.save_weights_file(port_pkl, model, cfg_yaml='x: 1')
    a, _ = checkpoint.load_weights_pkl(jax_pkl)
    b, saved_cfg = checkpoint.load_weights_pkl(port_pkl)
    assert saved_cfg == 'x: 1'
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_noisy_tower_initialises_from_the_clean_blobs(tmp_path):
    """A VGG-style pkl without the noisy tower: '_[noisy]_fc6_w' loads
    from 'fc6_w'. Blob names may carry a 'gpu_0/' scope."""
    params = _flagship_jax_params()
    model = detector.build_model(
        detector.ModelSpec(num_classes=5, hidden_dim=8), device='cpu')
    full = str(tmp_path / 'full.pkl')
    checkpoint.save_weights_file(full, model)
    blobs, _ = checkpoint.load_weights_pkl(full)
    clean = {'gpu_0/' + k: v for k, v in blobs.items()
             if not k.startswith('_[noisy]_')}
    path = str(tmp_path / 'clean.pkl')
    save_object({'blobs': clean}, path)
    fresh = detector.build_model(
        detector.ModelSpec(num_classes=5, hidden_dim=8), device='cpu',
        seed=99)
    assert checkpoint.initialize_from_weights_file(fresh, path) == []
    for layer in ('fc6', 'fc7'):
        for p in ('weight', 'bias'):
            noisy = fresh.state_dict()['head.noisy.%s.%s' % (layer, p)]
            assert torch.equal(noisy, model.state_dict()[
                'head.clean.%s.%s' % (layer, p)])
    # the JAX loader reads the same file to the same weights
    template = {k: np.zeros_like(v) for k, v in params.items()}
    jax_params, _, unmatched = jax_ckpt.initialize_params_from_weights_file(
        template, path)
    assert unmatched == []
    bridged = params_from_jax(jax_params)
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, bridged[key]), key
    assert load_object(path)['blobs']


def test_shape_mismatch_raises_when_strict(tmp_path):
    model = detector.build_model(
        detector.ModelSpec(num_classes=5, hidden_dim=8), device='cpu')
    path = str(tmp_path / 'bad.pkl')
    save_object({'blobs': {'fc8c_w': np.zeros((3, 3), np.float32)}}, path)
    with pytest.raises(ValueError):
        checkpoint.initialize_from_weights_file(model, path)
    unmatched = checkpoint.initialize_from_weights_file(
        model, path, strict_shapes=False)
    assert 'fc8c_w' in unmatched
