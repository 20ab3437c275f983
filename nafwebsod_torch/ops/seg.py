"""Weakly supervised segmentation ops (port of the JAX package's
``ops/seg.py``, the part the two WSL mask heads call):

  * ``mask_utility`` and ``weighted_sigmoid_cross_entropy_with_logits``:
    the fcn mask head's image-label loss (per-RoI labels broadcast from the
    image labels, weights from the detection scores);
  * ``upsample_bilinear_wsl``: bilinear resize of a (B, C, h, w) map;
  * ``deeplab_utility_sigmoid``: per-pixel soft targets in {0, 0.5, 1}
    from CPG saliency maps;
  * ``cpg_sw``: the switch from CPG saliency to the learned mask;
  * ``dense_crf``: mean-field dense CRF, the spatial kernel as an exact
    separable Gaussian blur on the grid and the bilateral kernel through
    the permutohedral lattice (``ops/permutohedral.py``).

Not ported: the softmax variant of the deeplab targets and the end-to-end
Mask R-CNN loss (``crop_and_resize_masks``, ``e2e_mask_loss``).
"""

import torch
import torch.nn.functional as F

from nafwebsod_torch.ops import permutohedral as ph


def upsample_bilinear_wsl(x, out_h, out_w):
    """(B, C, h, w) -> (B, C, out_h, out_w), bilinear with half-pixel
    centres. Like ``jax.image.resize`` it widens the triangle filter when
    it shrinks an axis (``antialias``); when it enlarges, that changes
    nothing."""
    return F.interpolate(x, size=(out_h, out_w), mode='bilinear',
                         align_corners=False, antialias=True)


def deeplab_utility_sigmoid(cpg, labels_oh, cls_prob, tau=0.7,
                            fg_threshold=0.7, bg_threshold=0.1):
    """Per-class soft targets in {0, 0.5, 1}: 1 at or above the foreground
    threshold, 0 at or below the background threshold, 0.5 (ignored)
    between; all 0.5 for a class predicted below ``tau`` or labelled 0.5,
    all 0 for a class the image does not have. cpg: (B, C, H, W);
    labels_oh, cls_prob: (B, C). Returns (B, C, H, W)."""
    lab = labels_oh[:, :, None, None]
    pred = cls_prob[:, :, None, None]
    half = cpg.new_full((), 0.5)
    zero = cpg.new_zeros(())
    out = torch.where(cpg >= fg_threshold, cpg.new_ones(()),
                      torch.where(cpg <= bg_threshold, zero, half))
    out = torch.where(pred < tau, half, out)
    out = torch.where(lab == 0.5, half, out)
    return torch.where(lab == 0, zero, out)


def weighted_sigmoid_cross_entropy_with_logits(logits, targets, weights):
    """Elementwise sigmoid CE scaled by ``weights``, averaged over the
    class axis per row: (N, C) -> (N,)."""
    elem = (logits.clamp(min=0) - logits * targets +
            torch.log1p(torch.exp(-logits.abs())))
    return (elem * weights).mean(dim=1)


def mask_utility(rois_pred, rois, labels_oh):
    """Per-RoI mask labels broadcast from the (1, C-1) image labels, and
    per-RoI class weights taken from the detection scores with no gradient.
    Returns (mask_w (R, C-1), mask_rois (R, 5), mask_labels (R, C-1))."""
    mask_labels = labels_oh.expand(rois.shape[0], labels_oh.shape[1])
    return rois_pred.detach(), rois, mask_labels


def cpg_sw(cpg, mask_logits_up, loss_per_class, labels_oh, cls_prob,
           tau=0.7, min_loss=0.1, active=True):
    """Per (image, class): once the class is labelled, predicted at
    ``tau`` or more and its segmentation loss is at most ``min_loss``, the
    sigmoid of the mask logits replaces the CPG map. ``active`` is the
    iteration cutoff. cpg, mask_logits_up: (B, C, H, W); the others
    (B, C)."""
    use_mask = ((labels_oh >= 0.5) & (cls_prob >= tau) &
                (loss_per_class <= min_loss))
    if not active:
        use_mask = torch.zeros_like(use_mask)
    return torch.where(use_mask[:, :, None, None],
                       torch.sigmoid(mask_logits_up), cpg)


def _gaussian_blur(x, sigma, truncate=2.0):
    """Separable Gaussian blur over the last two axes with zero padding.
    The kernel's radius is clamped per axis so that it never exceeds the
    signal."""
    def blur_last(v):
        length = v.shape[-1]
        radius = max(min(int(truncate * sigma + 0.5), (length - 1) // 2), 1)
        t = torch.arange(-radius, radius + 1, dtype=torch.float32,
                         device=v.device)
        k = torch.exp(-0.5 * (t / sigma) ** 2)
        k = k / k.sum()
        return F.conv1d(v.reshape(-1, 1, length), k[None, None],
                        padding=radius).reshape(v.shape)

    x = blur_last(x)
    return blur_last(x.transpose(-1, -2)).transpose(-1, -2)


@torch.no_grad()
def dense_crf(unary, image, num_iters=10, pos_w=3.0, pos_std=3.0, bi_w=10.0,
              bi_std=80.0, bi_rgb_std=13.0, size_std=500.0):
    """Mean-field dense CRF with Gaussian and bilateral Potts terms.

    unary: (C, H, W) negative log-probabilities; image: (H, W, 3) in the
    loader's mean-subtracted pixel scale (the bilateral affinity uses
    colour differences, so the mean shift cancels). Returns refined
    (C, H, W) probabilities, a constant for the gradient.

    The spatial standard deviations POS_XY_STD 3 and BI_XY_STD 80 are
    divided by ``size_std / max(H, W)``, the colour one is 13; the update
    is Q = softmax(-U + sum_k w_k * kbar_k(Q)) with symmetric kernel
    normalisation, ten times; the result is clamped at 1e-4 and
    renormalised. The lattice's splat sums floats with ``index_add_`` in
    an order of its own, and ten iterations carry that on: see the tests
    for the tolerance against the JAX package."""
    c, h, w = unary.shape
    dev = unary.device
    scale_factor = size_std / float(max(h, w))
    pos_sigma = pos_std / scale_factor
    bi_sigma = bi_std / scale_factor

    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing='ij')
    coords = torch.stack([xs, ys], -1).reshape(-1, 2)
    feat_bi = torch.cat([coords / bi_sigma,
                         image.float().reshape(-1, 3) / bi_rgb_std], dim=-1)

    def blur_pos(v):                                            # (HW, V)
        x = v.T.reshape(-1, h, w)
        return _gaussian_blur(x, pos_sigma).reshape(-1, h * w).T

    lat_bi = ph.build_lattice(feat_bi)
    ones = unary.new_ones((h * w, 1), dtype=torch.float32)
    norm_pos = torch.rsqrt(blur_pos(ones).clamp(min=1e-20))
    norm_bi = torch.rsqrt(ph.apply(lat_bi, ones).clamp(min=1e-20))

    u = unary.float().reshape(c, h * w).T                       # (HW, C)
    q = torch.softmax(-u, dim=1)
    for _ in range(num_iters):
        msg = (pos_w * norm_pos * blur_pos(q * norm_pos) +
               bi_w * norm_bi * ph.apply(lat_bi, q * norm_bi))
        q = torch.softmax(-u + msg, dim=1)
    q = q.clamp(min=1e-4)
    q = q / q.sum(dim=1, keepdim=True)
    return q.T.reshape(c, h, w)
