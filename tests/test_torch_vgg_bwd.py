"""Gradients through the port's VGG16 body (nafwebsod_torch/models/vgg16.py)
against the JAX package on the CPU: the 2x2 max pools route a window's
cotangent to its FIRST max in row-major window order, also on tied inputs
(ReLU zeros are the common tie), and ``freeze_at`` stops the gradient where
the JAX body stops it.

Tolerances: the stride-2 pool is exact (each input cell belongs to one
window); the stride-1 pool sums up to four contributions in another
order, rtol 1e-6; the image gradient through the body at rtol 1e-3,
atol 1e-5 (13 float32 convolutions, sums reassociated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nafwebsod_tpu.models import vgg16 as jax_vgg16
from nafwebsod_torch.models import detector, vgg16
from nafwebsod_torch.utils.bridge import params_from_jax


@pytest.mark.parametrize('stride', [2, 1])
@pytest.mark.parametrize('layout', ['contiguous', 'channels_last'])
def test_max_pool_backward_routes_to_the_first_max_on_ties(stride, layout):
    rng = np.random.RandomState(stride)
    # few levels, mostly zero: nearly every window is tied
    x = np.maximum(rng.randint(-4, 3, (1, 9, 11, 5)), 0).astype(np.float32)
    g_shape = (1, 4, 5, 5) if stride == 2 else (1, 8, 10, 5)
    g = rng.randn(*g_shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(
        jax_vgg16._maxpool(v, stride) * jnp.asarray(g)))(jnp.asarray(x))
    leaf = torch.from_numpy(x).permute(0, 3, 1, 2)
    if layout == 'channels_last':
        leaf = leaf.contiguous(memory_format=torch.channels_last)
    else:
        leaf = leaf.contiguous()
    leaf.requires_grad_(True)
    out = F.max_pool2d(leaf, 2, stride)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    got = leaf.grad.permute(0, 2, 3, 1).numpy()
    if stride == 2:
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.fixture(scope='module')
def body():
    params = {k: np.asarray(v) for k, v in jax_vgg16.init_params(
        jax.random.PRNGKey(0), dilation=2).items()}
    model = vgg16.VGG16(2, device='cpu')
    model.load_state_dict({k[len('body.'):]: v
                           for k, v in params_from_jax(params).items()
                           if k.startswith('body.')})
    return params, model


def test_image_gradient_through_the_body_matches_jax(body):
    params, model = body
    rng = np.random.RandomState(0)
    image = (rng.randn(1, 48, 64, 3) * 20).astype(np.float32)
    feat_shape = (1,) + vgg16.feature_shape(48, 64) + (512,)
    g = rng.randn(*feat_shape).astype(np.float32)
    want = jax.grad(lambda im: jnp.sum(jax_vgg16.forward(
        {k: jnp.asarray(v) for k, v in params.items()}, im, dilation=2,
        freeze_at=0)[0] * jnp.asarray(g)))(jnp.asarray(image))
    leaf = torch.from_numpy(image).requires_grad_(True)
    feat, _ = model(leaf, freeze_at=0)
    feat.backward(torch.from_numpy(g))
    scale = np.abs(np.asarray(want)).max()
    assert scale > 0
    np.testing.assert_allclose(leaf.grad.numpy() / scale,
                               np.asarray(want) / scale, rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize('freeze_at', [0, 2, 5])
def test_freeze_at_stops_the_gradient_below_its_stage(body, freeze_at):
    _, model = body
    image = torch.randn(1, 32, 32, 3,
                        generator=torch.Generator().manual_seed(0))
    leaf = image.clone().requires_grad_(True)
    for p in model.parameters():
        p.grad = None
    feat, _ = model(leaf, freeze_at=freeze_at)
    if freeze_at == 5:
        assert not feat.requires_grad
        return
    feat.sum().backward()
    assert (leaf.grad is not None) == (freeze_at == 0)
    for si, stage in enumerate(vgg16.VGG16_STAGES):
        for name, _, _ in stage:
            has = getattr(model, name).weight.grad is not None
            assert has == (si >= freeze_at), name


def test_trainable_param_names_follow_the_freeze_keys():
    frozen = detector.build_model(detector.ModelSpec(
        num_classes=5, hidden_dim=8), device='cpu')
    names = detector.trainable_param_names(frozen)
    assert names and all(n.startswith('head.') for n in names)
    assert 'head.noisy.fc6.weight' in names
    partly = detector.build_model(detector.ModelSpec(
        num_classes=5, hidden_dim=8, freeze_conv_body=False, freeze_at=2,
        box_head='vgg16_2fc', webly_on=False), device='cpu')
    names = detector.trainable_param_names(partly)
    assert 'body.conv2_2.weight' not in names
    assert 'body.conv3_1.weight' in names and 'head.fc8c.bias' in names
    assert not any('noisy' in n for n in names)
