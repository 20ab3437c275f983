"""The port's flagship model (nafwebsod_torch/models) against the JAX
package on bridged weights, on the CPU.

Tolerances: the VGG body at atol 2e-4 in float32 (convolutions reassociate
float32 sums; the bound of tests/test_oracle_parity.py); forward_test
scores at rtol 1e-4, atol 1e-5 in float32, against the JAX function and
the stored golden fixture (tests/test_golden_forward.py); bfloat16 scores
at atol 3e-3 (the two frameworks round bf16 activations at different
points).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafwebsod_tpu.models import detector as jax_detector
from nafwebsod_tpu.models import vgg16 as jax_vgg16
from nafwebsod_torch.core import config as port_config
from nafwebsod_torch.models import detector, vgg16
from nafwebsod_torch.utils.bridge import params_from_jax

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden',
                      'flagship_forward.npz')


def _jax_params(spec, key=0):
    params = jax_detector.init_params(spec, jax.random.PRNGKey(key))
    return {k: np.asarray(v) for k, v in params.items()}


def _port_model(params, dtype='float32', num_classes=5, hidden=8):
    model = detector.build_model(
        detector.ModelSpec(num_classes=num_classes, hidden_dim=hidden,
                           compute_dtype=dtype), device='cpu')
    model.load_state_dict(params_from_jax(params))
    return model


def _golden_inputs(h=48, w=64, r=10):
    """The inputs of tests/test_golden_forward.py."""
    rng = np.random.RandomState(123)
    image = rng.randn(1, h, w, 3).astype(np.float32)
    x1 = rng.uniform(0, w - 20, r)
    y1 = rng.uniform(0, h - 20, r)
    rois = np.stack([np.zeros(r), x1, y1, np.minimum(x1 + 16, w - 1),
                     np.minimum(y1 + 16, h - 1)], 1).astype(np.float32)
    obn = (rng.rand(r, 1) + 1).astype(np.float32)
    return image, rois, obn


@pytest.fixture(scope='module')
def flagship_params():
    return _jax_params(jax_detector.ModelSpec(
        num_classes=5, hidden_dim=8, compute_dtype='float32'))


@pytest.mark.parametrize('h,w,pixel_std', [(40, 56, 40.0), (64, 96, 8.0)])
def test_body_matches_jax(flagship_params, h, w, pixel_std):
    rng = np.random.RandomState(h)
    image = (rng.randn(1, h, w, 3) * pixel_std).astype(np.float32)
    want, want_scale = jax_vgg16.forward(
        {k: jnp.asarray(v) for k, v in flagship_params.items()},
        jnp.asarray(image), dilation=2)
    model = _port_model(flagship_params)
    feat, scale = model.body_forward(torch.from_numpy(image))
    assert scale == want_scale == 0.125
    assert tuple(feat.shape[1:3]) == vgg16.feature_shape(h, w)
    assert feat[0].is_contiguous()  # channels_last: the map K1 reads
    np.testing.assert_allclose(feat.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)


def test_forward_test_matches_jax_and_golden(flagship_params):
    image, rois, obn = _golden_inputs()
    spec = jax_detector.ModelSpec(num_classes=5, hidden_dim=8,
                                  compute_dtype='float32')
    want = jax_detector.forward_test(
        spec, {k: jnp.asarray(v) for k, v in flagship_params.items()},
        jnp.asarray(image), jnp.asarray(rois), jnp.asarray(obn),
        jnp.ones((10,), bool))
    out = _port_model(flagship_params).forward_test(
        torch.from_numpy(image), torch.from_numpy(rois),
        torch.from_numpy(obn))
    scores = out['scores'].numpy()
    assert scores.shape == (10, 5)
    np.testing.assert_allclose(scores, np.asarray(want['scores']),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(scores, np.load(GOLDEN)['scores'],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(scores[:, 0], scores[:, 1])


def test_forward_test_bf16_matches_jax(flagship_params):
    image, rois, obn = _golden_inputs()
    spec = jax_detector.ModelSpec(num_classes=5, hidden_dim=8,
                                  compute_dtype='bfloat16')
    want = jax_detector.forward_test(
        spec, {k: jnp.asarray(v) for k, v in flagship_params.items()},
        jnp.asarray(image), jnp.asarray(rois), jnp.asarray(obn),
        jnp.ones((10,), bool))
    out = _port_model(flagship_params, 'bfloat16').forward_test(
        torch.from_numpy(image), torch.from_numpy(rois),
        torch.from_numpy(obn))
    assert out['scores'].dtype == torch.float32  # fc8 logits are f32
    np.testing.assert_allclose(out['scores'].numpy(),
                               np.asarray(want['scores']), atol=3e-3)


def test_valid_mask_matches_jax(flagship_params):
    image, rois, obn = _golden_inputs()
    valid = np.arange(10) < 7
    spec = jax_detector.ModelSpec(num_classes=5, hidden_dim=8,
                                  compute_dtype='float32')
    want = jax_detector.forward_test(
        spec, {k: jnp.asarray(v) for k, v in flagship_params.items()},
        jnp.asarray(image), jnp.asarray(rois), jnp.asarray(obn),
        jnp.asarray(valid))
    out = _port_model(flagship_params).forward_test(
        torch.from_numpy(image), torch.from_numpy(rois),
        torch.from_numpy(obn), torch.from_numpy(valid))
    np.testing.assert_allclose(out['scores'].numpy(),
                               np.asarray(want['scores']), rtol=1e-4,
                               atol=1e-5)


def test_fc_logits_sum_bf16_products_in_f32():
    """The bf16 fc8 trap: products of bf16 values summed in float32, not a
    bf16 GEMM upcast afterwards."""
    from nafwebsod_torch.models.heads import fc
    rng = np.random.RandomState(0)
    layer = torch.nn.Linear(256, 3)
    x = torch.from_numpy(rng.randn(4, 256).astype(np.float32)).bfloat16()
    got = fc(x, layer, torch.float32)
    want = (x.double() @ layer.weight.detach().bfloat16().double().T
            + layer.bias.detach().double())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_seeded_init_follows_jax_schemes():
    spec = detector.ModelSpec(num_classes=5, hidden_dim=64)
    a = detector.build_model(spec, device='cpu', seed=3)
    b = detector.build_model(spec, device='cpu', seed=3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.body.conv3_1.weight
    assert abs(w.std().item() - np.sqrt(2.0 / (9 * 128))) < 0.01 * w.std()
    fc6 = a.head.clean.fc6.weight
    bound = np.sqrt(3.0 / fc6.shape[1])
    assert fc6.abs().max().item() <= bound
    assert fc6.abs().max().item() > 0.99 * bound
    assert not a.head.clean.fc6.bias.any()


def test_spec_from_flagship_cfg():
    port_config.reset_cfg()
    try:
        port_config.merge_cfg_from_cfg(port_config.FLAGSHIP)
        spec = detector.spec_from_cfg(port_config.cfg)
        assert spec == detector.ModelSpec(
            num_classes=21, dilation=2, compute_dtype='bfloat16',
            hidden_dim=4096)
        assert spec.dtype == torch.bfloat16
        port_config.cfg.WSL.OICR = True
        with pytest.raises(NotImplementedError):
            detector.spec_from_cfg(port_config.cfg)
        port_config.cfg.WSL.OICR = False
        port_config.cfg.MODEL.CONV_BODY = 'ResNet.add_ResNet50_conv4_body'
        with pytest.raises(NotImplementedError):
            detector.spec_from_cfg(port_config.cfg)
    finally:
        port_config.reset_cfg()


def test_build_model_without_device_raises_on_a_gpu_less_box():
    if torch.cuda.is_available():
        pytest.skip('this box has a GPU')
    with pytest.raises(RuntimeError):
        detector.build_model(detector.ModelSpec(hidden_dim=8))
