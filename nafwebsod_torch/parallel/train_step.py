"""The train step on one card (port of the JAX package's
``parallel/train_step.py`` at one image per step): forward, gradient of the
total loss with respect to the trainable parameters, solver update. No
mesh and no multi-step loop: every WSL configuration trains one image
per device.
"""

import numpy as np
import torch

from nafwebsod_torch.solver import sgd
from nafwebsod_torch.utils.bridge import named_blobs

BATCH_KEYS = ('image', 'rois', 'obn_scores', 'labels_oh', 'valid_mask',
              'im_hw')


def stack_minibatches(blob_list, size_bucket=None):
    """List of per-image minibatch blob dicts -> one batch dict of numpy
    arrays with a leading image axis. Images are zero-padded to the
    largest height and width (rounded up to ``size_bucket``); ``image``
    comes out as (B, 1, H, W, 3), the per-image forward's rank; ``im_hw``
    keeps each image's own extent on that canvas (the context head clips
    its rings there)."""
    ims = [b['data'][0] for b in blob_list]
    h = max(im.shape[0] for im in ims)
    w = max(im.shape[1] for im in ims)
    if size_bucket:
        h = ((h + size_bucket - 1) // size_bucket) * size_bucket
        w = ((w + size_bucket - 1) // size_bucket) * size_bucket
    canvas = np.zeros((len(ims), h, w, 3), dtype=np.float32)
    for i, im in enumerate(ims):
        canvas[i, :im.shape[0], :im.shape[1]] = im
    batch = {
        'image': canvas[:, None],
        'rois': np.stack([b['rois'] for b in blob_list]).astype(np.float32),
        'obn_scores': np.stack(
            [b['obn_scores'] for b in blob_list]).astype(np.float32),
        'labels_oh': np.stack(
            [b['labels_oh'] for b in blob_list]).astype(np.float32),
        'valid_mask': np.stack([b['valid_mask'] for b in blob_list]),
        'im_hw': np.stack([b['im_hw'] for b in blob_list]).astype(np.float32),
    }
    return batch


def to_device_batch(batch, device, cur_iter=0.0):
    """The one image of a stacked numpy batch as tensors on ``device``,
    plus ``cur_iter`` (it gates CSC)."""
    if batch['image'].shape[0] != 1:
        raise NotImplementedError(
            'the port trains one image per step, got a batch of {}'.format(
                batch['image'].shape[0]))
    out = {k: torch.from_numpy(np.ascontiguousarray(batch[k][0])).to(device)
           for k in BATCH_KEYS}
    out['cur_iter'] = float(cur_iter)
    return out


def train_step(model, opt_state, batch, lr, generator=None, *, hp, mults):
    """One step, in place on ``model``'s parameters and ``opt_state``.

    batch: one image's tensors on the model's device (``to_device_batch``);
    ``generator`` draws the dropout masks (None: no dropout); ``mults`` maps
    blob names to (lr_mult, decay_mult), (0, 0) for frozen parameters.
    Returns (loss, aux) detached."""
    params = named_blobs(model)
    names = [n for n in params if mults[n] != (0.0, 0.0)]
    total, aux = model.forward_train(batch, generator)
    grads = torch.autograd.grad(total, [params[n] for n in names])
    sgd.update(params, dict(zip(names, grads)), opt_state, lr, hp, mults)
    return total.detach(), {k: v.detach() for k, v in aux.items()}
