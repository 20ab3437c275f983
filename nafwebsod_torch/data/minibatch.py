"""Test-time image blob construction (port of the JAX package's
``data/minibatch.py:prep_im_for_blob`` / ``pad_image_to_bucket`` and
``ops/image.py:compute_im_scale`` / ``scaled_size``).

No cv2: the resize is ``aten.upsample_bilinear2d`` with EXPLICIT scales.
``cv2.resize(fx=s)`` maps output pixel ``o`` to source ``(o + .5) / s - .5``
and sizes the output with cvRound; ``F.interpolate(size=...)`` would map
with ``in / out`` instead, which differs from cv2 by up to ~127 pixel
units at non-integer scales. Passing ``s`` as the scale reproduces cv2's
mapping (to ~1.5e-2 pixel units on float images).
"""

import numpy as np
import torch


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
