"""Image blobs and per-image training minibatches (port of the JAX
package's ``data/minibatch.py`` for the WSL branch, and of
``ops/image.py:compute_im_scale`` / ``scaled_size``).

A roidb entry carries its image under ``'image'`` as an (H, W, 3) uint8 BGR
array or as a path (``read_image``; ``data/json_dataset.py`` gives paths).
Training blobs are numpy
arrays, as in the JAX package: the HSV saturation / exposure jitter, the
random crop, the random TRAIN.SCALES choice, the top-k proposals with
their ``+1`` objectness boost projected onto the crop, one-hot image
labels, RoIs padded to a fixed count with a validity mask, and
bagging-mixup of two such blobs.

No cv2: the resize is ``aten.upsample_bilinear2d`` with EXPLICIT scales.
``cv2.resize(fx=s)`` maps output pixel ``o`` to source ``(o + .5) / s - .5``
and sizes the output with cvRound; ``F.interpolate(size=...)`` would map
with ``in / out`` instead, which differs from cv2 by up to ~127 pixel
units at non-integer scales. Passing ``s`` as the scale reproduces cv2's
mapping (to ~1.5e-2 pixel units on float images).
"""

import os

import numpy as np
import torch

from nafwebsod_torch.core.config import cfg


def compute_im_scale(h, w, target_size, max_size):
    """Short side to ``target_size``, long side capped at ``max_size``."""
    im_size_min = min(h, w)
    im_size_max = max(h, w)
    im_scale = float(target_size) / float(im_size_min)
    if np.round(im_scale * im_size_max) > max_size:
        im_scale = float(max_size) / float(im_size_max)
    return im_scale


def scaled_size(h, w, im_scale):
    """Resized dims with cv2.resize's dsize rounding (cvRound)."""
    return (int(np.rint(h * im_scale)), int(np.rint(w * im_scale)))


def read_image(image):
    """The (H, W, 3) uint8 BGR pixels of a roidb entry's ``'image'``: the
    array itself, or the file at that path read with OpenCV (imported
    here, so that arrays need no OpenCV)."""
    if not isinstance(image, (str, bytes)) and not hasattr(image,
                                                            '__fspath__'):
        return np.asarray(image)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            'reading the image file {} needs OpenCV (cv2), which is not '
            'installed; install it or hand the pixels over as an (H, W, 3) '
            'uint8 BGR array in the entry'.format(image)) from e
    im = cv2.imread(os.fspath(image))
    if im is None:
        raise FileNotFoundError('cannot read image {}'.format(image))
    return im


def prep_im_for_blob(im, pixel_means, target_size, max_size,
                     pixel_stds=None, device='cpu'):
    """Mean-subtract (and std-divide), then bilinear-resize so the short
    side is ``target_size`` with the long side capped at ``max_size``.

    im: (H, W, 3) BGR image (numpy or tensor, any real dtype). Returns
    ((H', W', 3) float32 tensor on ``device``, im_scale). The normalisation
    is computed in float64 and rounded to float32 after each step, as the
    numpy path does with its float64 means."""
    x = torch.as_tensor(np.asarray(im), device=device).to(torch.float64)
    x = (x - torch.as_tensor(np.asarray(pixel_means, np.float64),
                             device=device).reshape(1, 1, -1)).float()
    if pixel_stds is not None:
        x = (x.double() / torch.as_tensor(
            np.asarray(pixel_stds, np.float64),
            device=device).reshape(1, 1, -1)).float()
    h, w = x.shape[:2]
    im_scale = compute_im_scale(h, w, target_size, max_size)
    oh, ow = scaled_size(h, w, im_scale)
    nchw = x.permute(2, 0, 1)[None].contiguous()
    out = torch.ops.aten.upsample_bilinear2d(nchw, [oh, ow], False,
                                             im_scale, im_scale)
    return out[0].permute(1, 2, 0).contiguous(), im_scale


def pad_image_to_bucket(im, multiple):
    """Zero-pad (H, W, C) up to a multiple of ``multiple``.

    The padding changes the numbers near the right and bottom edges (conv
    bias and ReLU on the zero canvas bleed back through later convs), so
    the port pads exactly as the JAX package does to give the same
    scores."""
    if multiple <= 1:
        return im
    h, w = im.shape[:2]
    ph = int(np.ceil(h / multiple) * multiple)
    pw = int(np.ceil(w / multiple) * multiple)
    if ph == h and pw == w:
        return im
    out = im.new_zeros((ph, pw, im.shape[2]))
    out[:h, :w] = im
    return out


def _bgr_to_hsv(im):
    """uint8 BGR -> float (H in [0, 180), S, V in [0, 255]), OpenCV's 8-bit
    HSV ranges, before rounding."""
    b, g, r = [im[..., i].astype(np.float64) for i in range(3)]
    v = np.maximum(np.maximum(b, g), r)
    span = v - np.minimum(np.minimum(b, g), r)
    s = np.where(v > 0, 255.0 * span / np.maximum(v, 1.0), 0.0)
    d = np.maximum(span, 1e-12)
    h = np.where(v == r, (g - b) / d,
                 np.where(v == g, 2.0 + (b - r) / d, 4.0 + (r - g) / d))
    h = np.where(span > 0, 60.0 * h, 0.0)
    return np.stack([np.where(h < 0, h + 360.0, h) / 2.0, s, v], -1)


def _hsv_to_bgr(hsv):
    """uint8 HSV (H in [0, 180)) -> uint8 BGR."""
    h = hsv[..., 0].astype(np.float64) / 30.0         # sector, [0, 6)
    s = hsv[..., 1].astype(np.float64) / 255.0
    v = hsv[..., 2].astype(np.float64)
    sector = np.floor(h).astype(np.int64) % 6
    f = h - np.floor(h)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    r = np.choose(sector, [v, q, p, p, t, v])
    g = np.choose(sector, [t, v, v, q, p, p])
    b = np.choose(sector, [p, p, t, v, v, q])
    return np.clip(np.rint(np.stack([b, g, r], -1)), 0, 255).astype(np.uint8)


def distort_image_hsv(im, saturation, exposure, rng):
    """HSV saturation / exposure jitter of a uint8 BGR image. The colour
    conversions are written out in numpy (OpenCV's 8-bit HSV ranges, within
    a few units of its fixed-point tables); the random draws are the JAX
    package's."""
    hsv = np.rint(_bgr_to_hsv(im)).astype(np.uint8)
    s0 = rng.random_sample() * (saturation - 1) + 1
    s1 = rng.random_sample() * (exposure - 1) + 1
    s0 = s0 if rng.random_sample() > 0.5 else 1.0 / s0
    s1 = s1 if rng.random_sample() > 0.5 else 1.0 / s1
    hsv = hsv.astype(np.float32)
    hsv[:, :, 1] = np.minimum(s0 * hsv[:, :, 1], 255)
    hsv[:, :, 2] = np.minimum(s1 * hsv[:, :, 2], 255)
    return _hsv_to_bgr(hsv.astype(np.uint8))


def random_crop(im, crop_frac, rng):
    """Random crop to ``crop_frac`` of each side; returns (im, crop_box)
    with crop_box = [y0, x0, y1, x1] inclusive."""
    im_shape = np.array(im.shape)
    crop_dims = im_shape[:2] * crop_frac
    r0 = rng.random_sample()
    r1 = rng.random_sample()
    s = im_shape[:2] - crop_dims
    s[0] *= r0
    s[1] *= r1
    crop_box = np.array(
        [s[0], s[1], s[0] + crop_dims[0] - 1, s[1] + crop_dims[1] - 1],
        dtype=np.int32)
    im = im[crop_box[0]:crop_box[2] + 1, crop_box[1]:crop_box[3] + 1, :]
    return im, crop_box


def project_im_rois(im_rois, im_scale, im_crop):
    """Clip RoIs to the crop window, shift to crop coordinates, and scale.
    im_crop is [y0, x0, y1, x1]."""
    rois = im_rois.astype(np.float32, copy=True)
    y0, x0, y1, x1 = [float(v) for v in im_crop]
    rois[:, 0] = np.clip(rois[:, 0], x0, x1)
    rois[:, 2] = np.clip(rois[:, 2], x0, x1)
    rois[:, 1] = np.clip(rois[:, 1], y0, y1)
    rois[:, 3] = np.clip(rois[:, 3], y0, y1)
    rois -= np.array([x0, y0, x0, y0], dtype=np.float32)
    return rois * im_scale


def get_image_blob(entry, target_size, rng=None):
    """Augment one training image. Returns (im (H, W, 3) float32 numpy,
    im_scale, im_crop)."""
    im = read_image(entry['image'])
    if entry.get('flipped', False):
        im = im[:, ::-1, :]
    rng = rng or np.random
    if cfg.WSL.USE_DISTORTION:
        im = distort_image_hsv(im, cfg.WSL.SATURATION, cfg.WSL.EXPOSURE, rng)
    if cfg.WSL.USE_CROP:
        im, im_crop = random_crop(im, cfg.WSL.CROP, rng)
    else:
        im_crop = np.array([0, 0, im.shape[0] - 1, im.shape[1] - 1],
                           dtype=np.int32)
    blob, im_scale = prep_im_for_blob(
        im, cfg.PIXEL_MEANS, target_size, cfg.TRAIN.MAX_SIZE, cfg.PIXEL_STDS)
    return blob.numpy(), im_scale, im_crop


def sample_rois(entry, im_scale, im_crop, num_classes, batch_size_per_im,
                pad_to=None):
    """The first ``batch_size_per_im`` proposals with the ``+1`` objectness
    boost, projected onto the crop and the scale, one-hot image labels,
    and all-zero padding rows up to ``pad_to`` marked invalid."""
    n = min(int(batch_size_per_im), entry['boxes'].shape[0])
    boxes = entry['boxes'][:n].copy()
    obn = entry['obn_scores'][:n].copy() + 1.0
    rois = project_im_rois(boxes, im_scale, im_crop)
    rois = np.hstack([np.zeros((rois.shape[0], 1), np.float32), rois])

    labels_oh = np.zeros((1, num_classes - 1), dtype=np.float32)
    labels_int = np.zeros((1,), dtype=np.int32)
    gt_inds = np.where(entry['gt_classes'] > 0)[0]
    if len(gt_inds) == 0:
        raise ValueError('image without gt labels in the training roidb')
    for cls in entry['gt_classes'][gt_inds]:
        labels_oh[0, cls - 1] = 1
        labels_int[0] = cls - 1

    valid = np.ones((rois.shape[0],), dtype=bool)
    if pad_to is not None and rois.shape[0] < pad_to:
        pad = pad_to - rois.shape[0]
        rois = np.vstack([rois, np.zeros((pad, 5), np.float32)])
        obn = np.vstack([obn, np.zeros((pad, 1), np.float32)])
        valid = np.concatenate([valid, np.zeros((pad,), bool)])
    return {
        'rois': rois.astype(np.float32),
        'obn_scores': obn.astype(np.float32),
        'labels_oh': labels_oh,
        'labels_int32': labels_int,
        'valid_mask': valid,
    }


def get_minibatch(entry, rng=None, pad_rois_to=None, size_bucket=None,
                  target_size=None):
    """All blobs of one training image (the WSL branch). ``entry`` holds
    ``image``, ``boxes`` (R, 4) proposals sorted by objectness,
    ``obn_scores`` (R, 1) and ``gt_classes`` (the image's classes, > 0)."""
    rng = rng or np.random
    if target_size is None:
        target_size = cfg.TRAIN.SCALES[rng.randint(0, len(cfg.TRAIN.SCALES))]
    im, im_scale, im_crop = get_image_blob(entry, target_size, rng)
    if size_bucket:
        im = pad_image_to_bucket(torch.from_numpy(im), size_bucket).numpy()
    blobs = sample_rois(entry, im_scale, im_crop, cfg.MODEL.NUM_CLASSES,
                        cfg.TRAIN.BATCH_SIZE_PER_IM, pad_to=pad_rois_to)
    blobs['data'] = im[None, :, :, :]  # (1, H, W, 3)
    blobs['im_scale'] = im_scale
    blobs['im_hw'] = np.array(im.shape[:2], np.float32)
    blobs['data_ids'] = np.array([entry.get('id', 0)], dtype=np.int32)
    return blobs


def mixup_blobs(blobs_a, blobs_b, lam, max_rois=None):
    """Bagging-mixup: blend the two images and their one-hot labels with
    ``lam`` and keep the union of both images' RoIs. With ``max_rois`` the
    union is cut to the top boxes by objectness and padded back up to it."""
    a, b = blobs_a['data'], blobs_b['data']
    h = max(a.shape[1], b.shape[1])
    w = max(a.shape[2], b.shape[2])
    canvas = np.zeros((1, h, w, 3), dtype=np.float32)
    canvas[:, :a.shape[1], :a.shape[2]] += lam * a
    canvas[:, :b.shape[1], :b.shape[2]] += (1.0 - lam) * b
    out = dict(blobs_a)
    out['data'] = canvas
    out['im_hw'] = np.array([h, w], np.float32)
    out['labels_oh'] = (lam * blobs_a['labels_oh'] +
                        (1.0 - lam) * blobs_b['labels_oh'])

    va = blobs_a['valid_mask']
    vb = blobs_b['valid_mask']
    rois = np.vstack([blobs_a['rois'][va], blobs_b['rois'][vb]])
    obn = np.vstack([blobs_a['obn_scores'][va], blobs_b['obn_scores'][vb]])
    rois[:, 0] = 0
    if max_rois is not None and rois.shape[0] > max_rois:
        order = np.argsort(-obn[:, 0], kind='stable')[:max_rois]
        order.sort()
        rois, obn = rois[order], obn[order]
    n = rois.shape[0]
    valid = np.ones((n,), dtype=bool)
    if max_rois is not None and n < max_rois:
        pad = max_rois - n
        rois = np.vstack([rois, np.zeros((pad, 5), np.float32)])
        obn = np.vstack([obn, np.zeros((pad, 1), np.float32)])
        valid = np.concatenate([valid, np.zeros((pad,), bool)])
    out['rois'], out['obn_scores'], out['valid_mask'] = rois, obn, valid
    return out
