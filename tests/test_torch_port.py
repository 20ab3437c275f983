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
    assert int(count) >= 36      # the data and evaluator modules too
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


def test_chip_smoke_flagship_seed_blends_the_second_step():
    """chip_smoke.py's flagship training phase asserts that exactly its
    second step is a bagging-mixup blend; the draws are host-only numpy,
    so the seed is held here."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from nafwebsod_torch.engine.train import build_minibatch
    port_config.reset_cfg()
    try:
        port_config.merge_cfg_from_cfg(port_config.FLAGSHIP)
        cfg = port_config.cfg
        # smaller images: the draws do not depend on the scale
        cfg.TRAIN.SCALES = (96, 112, 128, 144, 160)
        roidb = chip_smoke.train_roidb(cfg.PIXEL_MEANS)
        rng = np.random.RandomState(chip_smoke.FLAGSHIP_TRAIN_SEED)
        blends = [bool(build_minibatch(roidb, i, rng).get('mixup', False))
                  for i in range(4)]
        assert blends == [False, True, False, False]
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
