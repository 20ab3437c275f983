"""The port's deeplab mask head (``SEG``: the ASPP head over conv5, CPG
pseudo labels, the dense CRF on the permutohedral lattice, the two mask
losses, image-level mask inference) against the JAX package on the CPU:
seeded numpy inputs, bridged weights, dropout off.

Tolerances: the loss ops and the resizes at rtol 1e-5, atol 1e-6; the
lattice's filtered values at rtol 1e-4, atol 1e-5 (``index_add_`` sums the
splat in another order than the segment sum) and against brute-force
Gaussian filtering at the accuracy the JAX package's own test states;
``dense_crf`` at atol 1e-4 on probabilities (ten mean-field iterations
carry the lattice's differences on); the ASPP head at rtol 1e-4, atol 1e-5
in float32 and atol 2e-2 in bfloat16 (the frameworks round twelve
bfloat16 convolutions at other places); ``deeplab_losses`` on the same CPG
maps at rtol 1e-4; the model's ``mask_seed_loss`` at rtol 5e-3: its CPG
maps are gradients summed in another order, and a saliency value that
crosses the 0.7 or 0.1 threshold flips a pixel's target; gradients of
the mask head at 5e-3 of each leaf's largest entry for the same reason,
of the box head at 1e-5 of it (float32 sums over the RoIs in an order that
depends on the machine's GEMM kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nafwebsod_tpu.core import config as jax_config
from nafwebsod_tpu.engine import test as jax_infer
from nafwebsod_tpu.models import detector as jax_detector
from nafwebsod_tpu.models import seg_head as jax_seg_head
from nafwebsod_tpu.ops import misc as jax_misc
from nafwebsod_tpu.ops import permutohedral as jax_ph
from nafwebsod_tpu.ops import seg as jax_seg
from nafwebsod_tpu.utils import checkpoint as jax_ckpt
from nafwebsod_torch.core import config as port_config
from nafwebsod_torch.engine import test as infer
from nafwebsod_torch.engine import test_engine
from nafwebsod_torch.engine import train as train_engine
from nafwebsod_torch.models import detector, seg_head
from nafwebsod_torch.ops import misc as misc_ops
from nafwebsod_torch.ops import permutohedral as ph
from nafwebsod_torch.ops import seg as seg_ops
from nafwebsod_torch.parallel import train_step as ts
from nafwebsod_torch.utils import checkpoint, segms
from nafwebsod_torch.utils.bridge import (blob_names, named_blobs,
                                          params_from_jax,
                                          state_to_jax_names)

TIGHT = dict(rtol=1e-5, atol=1e-6)
KW = dict(num_classes=5, hidden_dim=16, box_head='vgg16_2fc', webly_on=False,
          mask_on=True, mask_head='deeplab', cpg=True, cpg_tau=0.0,
          max_gt_cpg=2)


@pytest.fixture(autouse=True)
def _fresh_cfgs():
    jax_config.reset_cfg()
    port_config.reset_cfg()
    yield
    jax_config.reset_cfg()
    port_config.reset_cfg()


# --------------------------------------------------------------------------- #
# Loss ops and pseudo labels
# --------------------------------------------------------------------------- #

def test_kl_balanced_matches_jax():
    rng = np.random.RandomState(0)
    p = rng.rand(2, 6, 7, 4).astype(np.float32)
    q = rng.rand(2, 6, 7, 4).astype(np.float32)
    q[0, :2] = 0.5            # ignored
    q[1, 3] = 1e-6            # below the 1e-4 floor
    q[1, 4] = 0.0
    want = np.asarray(jax_misc.kl_balanced(jnp.asarray(p), jnp.asarray(q)))
    got = misc_ops.kl_balanced(torch.from_numpy(p), torch.from_numpy(q))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    one_side = np.full((1, 3, 3, 2), 0.9, np.float32)    # no negative side
    np.testing.assert_allclose(
        misc_ops.kl_balanced(torch.from_numpy(p[:1, :3, :3, :2]),
                             torch.from_numpy(one_side)).numpy(),
        np.asarray(jax_misc.kl_balanced(jnp.asarray(p[:1, :3, :3, :2]),
                                        jnp.asarray(one_side))), **TIGHT)


def test_wsl_sigmoid_cross_entropy_matches_jax():
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 4, 9, 8) * 4).astype(np.float32)
    targets = rng.choice([0.0, 0.5, 1.0], (2, 4, 9, 8)).astype(np.float32)
    targets[1, 2] = 0.5       # a class with every pixel ignored
    want, want_counts = jax_misc.sigmoid_cross_entropy_with_logits_wsl(
        jnp.asarray(logits), jnp.asarray(targets))
    got, counts = misc_ops.sigmoid_cross_entropy_with_logits_wsl(
        torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert got[1, 2].item() == 0.0


def test_deeplab_utility_and_cpg_sw_match_jax():
    rng = np.random.RandomState(2)
    cpg = rng.rand(2, 4, 6, 5).astype(np.float32)
    cpg[0, 1, 0, :3] = [0.7, 0.1, 0.4]         # exactly at the thresholds
    labels = np.array([[1, 1, 0, 0.5], [0, 1, 1, 1]], np.float32)
    pred = np.array([[0.9, 0.7, 0.9, 0.9], [0.9, 0.69, 0.8, 0.2]], np.float32)
    want = np.asarray(jax_seg.deeplab_utility_sigmoid(
        jnp.asarray(cpg), jnp.asarray(labels), jnp.asarray(pred)))
    got = seg_ops.deeplab_utility_sigmoid(
        torch.from_numpy(cpg), torch.from_numpy(labels),
        torch.from_numpy(pred))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0.0, 0.5, 1.0}
    logits = rng.randn(2, 4, 6, 5).astype(np.float32)
    loss = np.array([[0.05, 0.2, 0.05, 0.05], [0.05, 0.05, 0.1, 0.05]],
                    np.float32)
    for active in (True, False):
        want = np.asarray(jax_seg.cpg_sw(
            jnp.asarray(cpg), jnp.asarray(logits), jnp.asarray(loss),
            jnp.asarray(labels), jnp.asarray(pred), active=active))
        got = seg_ops.cpg_sw(
            torch.from_numpy(cpg), torch.from_numpy(logits),
            torch.from_numpy(loss), torch.from_numpy(labels),
            torch.from_numpy(pred), active=active).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert (got != cpg).any() == active


@pytest.mark.parametrize('out', [(37, 50), (9, 11), (5, 7), (13, 4)])
def test_upsample_bilinear_wsl_matches_jax_both_ways(out):
    rng = np.random.RandomState(3)
    x = rng.randn(1, 4, 9, 11).astype(np.float32)
    want = np.asarray(jax_seg.upsample_bilinear_wsl(jnp.asarray(x), *out))
    got = seg_ops.upsample_bilinear_wsl(torch.from_numpy(x), *out)
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)


def test_image_downscale_is_antialiased_as_jax_image_resize():
    """The CRF sees the image resized down to the mask grid:
    ``jax.image.resize`` widens its triangle filter when it shrinks, plain
    bilinear interpolation does not."""
    rng = np.random.RandomState(4)
    im = (rng.randn(1, 64, 72, 3) * 50).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(im[0]), (7, 9, 3),
                                       method='linear'))
    nchw = torch.from_numpy(im).permute(0, 3, 1, 2)
    got = F.interpolate(nchw, size=(7, 9), mode='bilinear',
                        align_corners=False, antialias=True)
    np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), want,
                               rtol=1e-5, atol=1e-4)
    plain = F.interpolate(nchw, size=(7, 9), mode='bilinear',
                          align_corners=False)
    assert np.abs(plain[0].permute(1, 2, 0).numpy() - want).max() > 10


# --------------------------------------------------------------------------- #
# The lattice and the CRF
# --------------------------------------------------------------------------- #

def _grid_features(h, w, sigma_s, image=None, sigma_r=None):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.stack([xs, ys], -1).reshape(-1, 2) / sigma_s
    if image is not None:
        f = np.concatenate([f, image.reshape(-1, 3) / sigma_r], -1)
    return f.astype(np.float32)


def _smooth_image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w, 3).astype(np.float32) * 255
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for _ in range(9):
        for ax in (0, 1):
            img = np.apply_along_axis(
                lambda r: np.convolve(r, k, mode='same'), ax, img)
    return img.astype(np.float32)


def _brute_normalized(f, v):
    d2 = ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1)
    kmat = np.exp(-0.5 * d2)
    dn = 1.0 / np.sqrt(kmat.sum(1))
    return dn[:, None] * (kmat @ (dn[:, None] * v))


@pytest.mark.parametrize('bilateral', [False, True])
def test_lattice_filter_against_brute_force(bilateral):
    h = w = 24
    rng = np.random.RandomState(1 + bilateral)
    if bilateral:
        f = _grid_features(h, w, 5.0, _smooth_image(h, w), 13.0)
    else:
        f = _grid_features(h, w, 3.0)
    v = rng.rand(h * w, 4).astype(np.float32)
    out, lattice = ph.gaussian_filter(torch.from_numpy(v),
                                      torch.from_numpy(f))
    ref = _brute_normalized(f, v)
    rel = np.abs(out.numpy() - ref) / (np.abs(ref) + 1e-6)
    if bilateral:      # the lattice approximation's accuracy class at d = 5
        assert rel.mean() < 0.05 and np.quantile(rel, 0.99) < 0.15
    else:
        assert rel.mean() < 0.02 and rel.max() < 0.10
    again, _ = ph.gaussian_filter(torch.from_numpy(v), None, lattice=lattice)
    assert torch.equal(again, out)


def test_lattice_equals_the_jax_packages():
    h, w = 12, 14
    rng = np.random.RandomState(5)
    f = _grid_features(h, w, 4.0, rng.rand(h, w, 3).astype(np.float32) * 40,
                       13.0)
    want = jax_ph.build_lattice(jnp.asarray(f))
    got = ph.build_lattice(torch.from_numpy(f))
    m = got['m']
    assert (got['n'], got['d']) == (h * w, 5)
    uid_j = np.asarray(want['entry_uid'])
    # the occupied points, in the same lexicographic order; a feature on a
    # simplex boundary may round to the neighbouring simplex (its weight on
    # the vertex that differs is then ~0)
    assert m == uid_j.max() + 1 < want['m']
    assert (got['entry_uid'].numpy() == uid_j).mean() > 0.99
    np.testing.assert_allclose(got['bary'].numpy(), np.asarray(want['bary']),
                               atol=1e-5)
    for key in ('n1', 'n2'):
        table = np.asarray(want[key])[:, :m]
        np.testing.assert_array_equal(
            got[key].numpy(), np.where(table >= want['m'], m, table))
        assert (got[key].numpy() == m).any() and (got[key].numpy() < m).any()
    v = rng.rand(h * w, 5).astype(np.float32)
    np.testing.assert_allclose(
        ph.apply(got, torch.from_numpy(v)).numpy(),
        np.asarray(jax_ph.apply(want, jnp.asarray(v))), rtol=1e-4, atol=1e-5)


def test_lattice_refuses_keys_too_wide_for_one_int64():
    f = torch.tensor(np.random.RandomState(6).rand(8, 5) * 1e5,
                     dtype=torch.float32)
    with pytest.raises(ValueError, match='int64'):
        ph.build_lattice(f)


def test_gaussian_blur_matches_jax():
    rng = np.random.RandomState(7)
    x = rng.rand(3, 12, 15).astype(np.float32)
    for sigma in (0.6, 1.7, 9.0):       # the last one clamps the radius
        np.testing.assert_allclose(
            seg_ops._gaussian_blur(torch.from_numpy(x), sigma).numpy(),
            np.asarray(jax_seg._gaussian_blur(jnp.asarray(x), sigma)),
            **TIGHT)


def test_dense_crf_matches_jax():
    rng = np.random.RandomState(8)
    h, w = 12, 14
    img = _smooth_image(h, w, 3) - 110.0
    probs = rng.dirichlet(np.ones(5), (h, w)).transpose(2, 0, 1)
    unary = -np.log(np.clip(probs, 1e-6, 1)).astype(np.float32)
    want = np.asarray(jax_seg.dense_crf(jnp.asarray(unary), jnp.asarray(img)))
    got = seg_ops.dense_crf(torch.from_numpy(unary), torch.from_numpy(img))
    assert got.shape == (5, h, w) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.sum(0).numpy(), 1.0, atol=1e-5)
    assert got.min().item() >= 1e-4 / 1.01
    # it refines: not the softmax of the unaries
    assert np.abs(got.numpy() - probs).max() > 0.05


# --------------------------------------------------------------------------- #
# The head and its losses
# --------------------------------------------------------------------------- #

def _head_params(rng, hidden=12, dim_in=16):
    params = jax_seg_head.init_deeplab_head_params(
        jax.random.PRNGKey(0), 5, dim_in=dim_in, hidden=hidden)
    return {k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
            for k, v in params.items()}


def _port_head(params, hidden=12, dim_in=16):
    head = seg_head.DeeplabHead(5, dim_in=dim_in, hidden=hidden)
    head.load_state_dict({k[len('mask_head.'):]: v
                          for k, v in params_from_jax(params).items()})
    return head


@pytest.mark.parametrize('dtype,tol', [
    ('float32', dict(rtol=1e-4, atol=1e-5)),
    ('bfloat16', dict(rtol=0, atol=2e-2))])
def test_deeplab_head_forward_matches_jax(dtype, tol):
    rng = np.random.RandomState(9)
    params = _head_params(rng)
    feat = np.maximum(rng.randn(1, 30, 34, 16), 0).astype(np.float32)
    jdt = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}[dtype]
    tdt = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[dtype]
    want = jax_seg_head.deeplab_head_forward(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(feat).astype(jdt))
    got = _port_head(params)(torch.from_numpy(feat).to(tdt))
    assert got.shape == (1, 30, 34, 4) and got.dtype == torch.float32
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_deeplab_head_pool_pads_with_minus_infinity_and_freezes():
    rng = np.random.RandomState(10)
    head = _port_head(_head_params(rng))
    # an all-negative map: a zero-padded pool would lift the border to 0
    feat = torch.from_numpy(-rng.rand(1, 8, 9, 16).astype(np.float32) - 1)
    feat.requires_grad_(True)
    out = head(feat, freeze_body=False)
    grad, = torch.autograd.grad(out.sum(), feat)
    assert grad.abs().sum() > 0
    frozen = head(feat, freeze_body=True)
    assert torch.equal(frozen, out)
    assert torch.autograd.grad(frozen.sum(), feat,
                               allow_unused=True)[0] is None
    want = jax_seg_head.deeplab_head_forward(
        {k: jnp.asarray(v) for k, v in _head_params(
            np.random.RandomState(10)).items()},
        jnp.asarray(feat.detach().numpy()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_deeplab_head_dropout_comes_from_the_generator():
    rng = np.random.RandomState(11)
    head = _port_head(_head_params(rng))
    feat = torch.from_numpy(rng.rand(1, 8, 9, 16).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    a = head(feat, train=True, generator=gen)
    b = head(feat, train=True, generator=gen)
    gen.manual_seed(3)
    assert torch.equal(head(feat, train=True, generator=gen), a)
    assert not torch.equal(a, b)
    # no generator, or not training: no dropout
    assert torch.equal(head(feat, train=True), head(feat))


def test_deeplab_outputs_and_losses_match_jax_on_the_same_maps():
    rng = np.random.RandomState(12)
    fc8 = (rng.randn(1, 8, 8, 4) * 2).astype(np.float32)
    cpg = rng.rand(1, 4, 64, 64).astype(np.float32)
    labels = np.array([[0, 1, 0, 1]], np.float32)
    cls_prob = np.array([[0.1, 0.9, 0.3, 0.75]], np.float32)
    image = (rng.randn(1, 64, 64, 3) * 40).astype(np.float32)
    for a, b in zip(seg_head.deeplab_outputs(torch.from_numpy(fc8)),
                    jax_seg_head.deeplab_outputs(jnp.asarray(fc8))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TIGHT)
    want = jax_seg_head.deeplab_losses(
        jnp.asarray(fc8), jnp.asarray(cpg), jnp.asarray(labels),
        jnp.asarray(cls_prob), jnp.asarray(image), tau=0.7)
    logits = torch.from_numpy(fc8).requires_grad_(True)
    got = seg_head.deeplab_losses(
        logits, torch.from_numpy(cpg), torch.from_numpy(labels),
        torch.from_numpy(cls_prob), torch.from_numpy(image), tau=0.7)
    assert set(got) == set(want) == {'mask_seed_loss', 'mask_constraint_loss'}
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    want_grad = jax.grad(lambda x: sum(jax_seg_head.deeplab_losses(
        x, jnp.asarray(cpg), jnp.asarray(labels), jnp.asarray(cls_prob),
        jnp.asarray(image), tau=0.7).values()))(jnp.asarray(fc8))
    grad, = torch.autograd.grad(sum(got.values()), logits)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=1e-3, atol=1e-6)
    only_seed = seg_head.deeplab_losses(
        logits, torch.from_numpy(cpg), torch.from_numpy(labels),
        torch.from_numpy(cls_prob), torch.from_numpy(image), tau=0.7,
        run_crf=False)
    assert set(only_seed) == {'mask_seed_loss'}


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #

def _fixture(seed=0, r=12, padded=3, labelled=(1, 3)):
    """(jax spec, jax params as numpy, port model, numpy batch). The ASPP
    head keeps the package's 1024-wide hidden layers; its weights are
    scaled up so that the mask logits are not all ~0."""
    spec = jax_detector.ModelSpec(**KW)
    params = {k: np.asarray(v) for k, v in jax_detector.init_params(
        spec, jax.random.PRNGKey(seed)).items()}
    for k in params:
        if k.startswith(('fc6_', 'fc7_', 'mask_fc8_')) and k.endswith('_w'):
            params[k] = params[k] * 3
    model = detector.build_model(detector.ModelSpec(**KW), device='cpu')
    model.load_state_dict(params_from_jax(params))
    rng = np.random.RandomState(seed)
    h, w = 48, 56
    canvas = np.zeros((1, 64, 64, 3), np.float32)
    canvas[:, :h, :w] = rng.randn(1, h, w, 3) * 8
    x1 = rng.uniform(0, w - 16, r)
    y1 = rng.uniform(0, h - 16, r)
    rois = np.stack([np.zeros(r), x1, y1,
                     np.minimum(x1 + rng.uniform(8, 30, r), w - 1),
                     np.minimum(y1 + rng.uniform(8, 30, r), h - 1)],
                    1).astype(np.float32)
    valid = np.arange(r) < r - padded
    rois[~valid] = 0
    obn = rng.uniform(0.5, 1.5, (r, 1)).astype(np.float32)
    obn[~valid] = 0
    labels = np.zeros((1, 4), np.float32)
    labels[0, list(labelled)] = 1
    batch = {'image': canvas, 'rois': rois, 'obn_scores': obn,
             'labels_oh': labels, 'valid_mask': valid}
    return spec, params, model, batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_deeplab_model_has_the_reference_blobs():
    _, params, model, _ = _fixture()
    names = blob_names(model)
    assert set(names) == set(model.state_dict())
    assert set(names.values()) == set(params)
    for blob in ('fc6_1_w', 'fc7_4_b', 'mask_fc8_2_w'):
        assert blob in params
    assert model.mask_head.fc6_3.dilation == (18, 18)
    assert model.mask_head.fc6_3.weight.shape == (1024, 512, 3, 3)


def test_forward_train_total_aux_and_gradients_match_jax():
    spec, params, model, batch = _fixture()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (want, want_aux), want_grads = jax.value_and_grad(
        lambda p: jax_detector.forward_train(spec, p, _jax(batch), None),
        has_aux=True)(jp)
    total, aux = model.forward_train(_port(batch))
    assert set(aux) == set(want_aux) == {
        'loss_cls', 'accuracy_cls', 'mask_seed_loss', 'mask_constraint_loss'}
    tols = {'mask_seed_loss': 5e-3}
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]),
                                   rtol=tols.get(k, 1e-4), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(total.item(), float(want), rtol=5e-3)
    assert aux['mask_seed_loss'].item() > 0.1
    assert aux['mask_constraint_loss'].item() > 1e-3
    blobs = named_blobs(model)
    names = [n for n in blobs if not n.startswith('conv')]
    grads = torch.autograd.grad(total, [blobs[n] for n in names])
    got = state_to_jax_names(dict(zip(names, grads)))
    for n in names:
        ref = np.asarray(want_grads[n])
        mask_leaf = n.startswith(('fc6_', 'fc7_', 'mask_fc8_'))
        # box head leaves: float32 sums over the RoIs in an order that
        # depends on the machine's GEMM kernels (and XLA's); mask leaves:
        # the CPG targets above
        np.testing.assert_allclose(
            got[n], ref, rtol=1e-3,
            atol=(5e-3 if mask_leaf else 1e-5) * max(np.abs(ref).max(), 1.0),
            err_msg=n)
        assert np.abs(ref).max() > 0, n
    for n in blobs:     # the frozen body takes no gradient from any loss
        if n.startswith('conv'):
            assert not np.asarray(want_grads[n]).any(), n


def test_a_padded_cpg_slot_does_not_wipe_class_zero():
    """The port scatters only the real slots of the selected classes. (The
    JAX package scatters the padded slots too, at index max(-1, 0) = 0
    with a zero map, so an image labelled with class 0 and fewer classes
    than TPU.CPG_MAX_GT loses that class's map there.)"""
    _, _, model, batch = _fixture(labelled=(0,))
    seen = {}
    real = seg_head.deeplab_losses

    def spy(mask_fc8, cpg, *args, **kwargs):
        seen['cpg'] = cpg
        return real(mask_fc8, cpg, *args, **kwargs)

    seg_head.deeplab_losses = spy
    try:
        model.forward_train(_port(batch))
    finally:
        seg_head.deeplab_losses = real
    cpg = seen['cpg']
    assert cpg.shape == (1, 4, 64, 64) and not cpg.requires_grad
    assert cpg[0, 0].max().item() > 0
    assert not cpg[0, 1:].any()


def test_three_deeplab_train_steps_move_every_mask_leaf():
    _, params, model, batch = _fixture()
    port_config.cfg.SOLVER.MOMENTUM = 0.9
    hp, mults, state = train_engine.create_solver(model)
    assert mults['fc6_1_w'] == (1.0, 1.0) and mults['mask_fc8_4_b'] == (2.0,
                                                                       0.0)
    assert mults['conv5_3_w'] == (0.0, 0.0)
    losses = []
    for _ in range(3):
        loss, aux = ts.train_step(model, state, _port(batch),
                                  np.float32(1e-4), None, hp=hp, mults=mults)
        losses.append(loss.item())
        assert np.isfinite([v.item() for v in aux.values()]).all()
    got = state_to_jax_names(named_blobs(model))
    for n in params:
        moved = (got[n] != params[n]).any()
        assert moved != n.startswith('conv'), n
    assert losses[2] < losses[0]


def test_forward_deeplab_masks_matches_jax():
    spec, params, model, batch = _fixture()
    want = np.asarray(jax_detector.forward_deeplab_masks(
        spec, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(batch['image'])))
    got = model.forward_deeplab_masks(torch.from_numpy(batch['image']))
    assert got.shape == (1, 7, 7, 5) and got.dtype == torch.float32
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[..., 0].numpy(),
                               1.0 - got[..., 1:].amax(-1).numpy(), atol=1e-6)
    assert np.ptp(want[..., 1:]) > 1e-3


def test_cpg_sw_with_the_deeplab_head_raises():
    cfg = port_config.cfg
    port_config.merge_cfg_from_cfg(port_config.SEG)
    assert detector.spec_from_cfg(cfg).is_deeplab
    cfg.WSL.CPG_MAX_ITER = 100
    with pytest.raises(NotImplementedError, match='CPG_MAX_ITER'):
        detector.spec_from_cfg(cfg)
    cfg.WSL.CPG_MAX_ITER = 0
    cfg.FAST_RCNN.ROI_BOX_HEAD = 'wsl_heads.add_VGG16_roi_context_2fc_head'
    with pytest.raises(NotImplementedError, match='deeplab'):
        detector.spec_from_cfg(cfg)


def test_deeplab_pkl_round_trip_is_bitwise(tmp_path):
    _, params, model, _ = _fixture()
    jax_pkl = str(tmp_path / 'jax.pkl')
    jax_ckpt.save_params_to_weights_file(jax_pkl, params)
    fresh = detector.build_model(detector.ModelSpec(**KW), device='cpu',
                                 seed=5)
    assert checkpoint.initialize_from_weights_file(fresh, jax_pkl) == []
    port_pkl = str(tmp_path / 'port.pkl')
    checkpoint.save_weights_file(port_pkl, fresh)
    a, _ = checkpoint.load_weights_pkl(jax_pkl)
    b, _ = checkpoint.load_weights_pkl(port_pkl)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------------------- #
# Mask inference
# --------------------------------------------------------------------------- #

def _seg_cfg(config):
    config.merge_cfg_from_cfg(port_config.SEG)
    c = config.cfg
    c.MODEL.NUM_CLASSES = 5
    c.TPU.HEAD_HIDDEN_DIM = 16
    c.TPU.COMPUTE_DTYPE = 'float32'
    c.TEST.SCALE = 64
    c.TEST.MAX_SIZE = 96
    c.TEST.DETECTIONS_PER_IM = 6


def test_segm_results_deeplab_equal_the_jax_packages():
    _seg_cfg(jax_config)
    _seg_cfg(port_config)
    rng = np.random.RandomState(13)
    yy, xx = np.mgrid[0:9, 0:11]
    grid = np.stack(
        [1 / (1 + np.exp(((yy - cy) ** 2 + (xx - cx) ** 2 - r2) / 4))
         for cy, cx, r2 in rng.uniform(3, 6, (5, 3)) * [1, 1, 6]], -1)[None]
    grid = grid.astype(np.float32)
    cls_boxes = [[], np.array([[2, 3, 40, 50, 0.9], [-3, 10, 20, 80, 0.5]],
                              np.float32),
                 np.zeros((0, 5), np.float32),
                 np.array([[30, 5, 84, 60, 0.8]], np.float32),
                 np.zeros((0, 5), np.float32)]
    boxes, _ = infer._final_boxes(cls_boxes)
    got = infer.segm_results(cls_boxes, grid, boxes, 66, 85)
    want = jax_infer.segm_results(cls_boxes, grid, boxes, 66, 85)
    assert [len(s) for s in got] == [0, 2, 0, 1, 0]
    filled = 0
    for j in (1, 3):
        for (g, w), box in zip(zip(got[j], want[j]), cls_boxes[j]):
            a, b = segms.rle_to_mask(g), segms.rle_to_mask(w)
            assert a.shape == (66, 85)
            assert (a != b).sum() <= 2       # a value within 1e-5 of 0.5
            ys, xs = np.nonzero(a)           # inside its box and the image
            if len(ys):
                filled += 1
                assert xs.min() >= max(box[0], 0) and xs.max() <= box[2]
                assert (ys.min() >= max(box[1], 0)
                        and ys.max() <= min(box[3], 65))
    assert filled == 3


def test_im_detect_all_with_the_deeplab_head_matches_jax():
    _seg_cfg(jax_config)
    _seg_cfg(port_config)
    spec = jax_detector.spec_from_cfg(jax_config.cfg)
    params = {k: np.asarray(v) for k, v in jax_detector.init_params(
        spec, jax.random.PRNGKey(3)).items()}
    for k in params:
        if k.startswith(('fc6_', 'fc7_', 'mask_fc8_')) and k.endswith('_w'):
            params[k] = params[k] * 3
    model = test_engine.initialize_model_from_cfg(device='cpu')
    model.load_state_dict(params_from_jax(params))
    rng = np.random.RandomState(14)
    im = rng.randint(0, 256, (50, 60, 3)).astype(np.uint8)
    x1 = rng.uniform(0, 48, 20)
    y1 = rng.uniform(0, 38, 20)
    boxes = np.round(np.stack([x1, y1, np.minimum(x1 + 30, 59),
                               np.minimum(y1 + 25, 49)], 1)).astype(
                                   np.float32)
    obn = rng.rand(20, 1).astype(np.float32)
    want_boxes, want_segms, _ = jax_infer.im_detect_all(
        spec, {k: jnp.asarray(v) for k, v in params.items()}, im, boxes, obn)
    cls_boxes, cls_segms, _ = infer.im_detect_all(model, im, boxes, obn)
    # the grid is cropped to the blob's extent before the resize: a 50x60
    # image at scale 64 is a 64x77 blob on a 64x128 canvas, ceil(77 / 8) =
    # 10 of the canvas's 15 columns
    grid = infer._mask_forward(model, im, boxes, 64, 96)
    assert grid.shape == (1, 7, 10, 5)
    assert model.forward_deeplab_masks(
        torch.zeros(1, 64, 128, 3)).shape == (1, 7, 15, 5)
    n_dets = 0
    for j in range(1, 5):
        np.testing.assert_allclose(cls_boxes[j], want_boxes[j], rtol=1e-4,
                                   atol=1e-6)
        assert len(cls_segms[j]) == len(cls_boxes[j]) == len(want_segms[j])
        for g, w in zip(cls_segms[j], want_segms[j]):
            a, b = segms.rle_to_mask(g), segms.rle_to_mask(w)
            assert a.shape == (50, 60) and (a != b).mean() < 0.002
            n_dets += 1
    assert 0 < n_dets <= 6
