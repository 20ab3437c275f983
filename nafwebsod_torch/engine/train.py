"""The training loop on one card (port of the JAX package's
``engine/train.py``: minibatch, learning rate, momentum correction at
learning-rate boundaries, the train step, a final checkpoint).

The roidb is a list of entries, each a dict with ``'image'`` (an (H, W, 3)
uint8 BGR array), ``'boxes'`` (R, 4) proposals sorted by objectness,
``'obn_scores'`` (R, 1) and ``'gt_classes'`` (the image's classes, > 0).
Not ported yet: dataset loading, the loader threads, periodic snapshots
and AUTO_RESUME, training statistics, a CLI.
"""

import logging
import os
import time

import numpy as np
import torch

from nafwebsod_torch.core.config import cfg, dump_cfg
from nafwebsod_torch.data.minibatch import (get_minibatch, mixup_blobs,
                                            pad_image_to_bucket)
from nafwebsod_torch.engine.test_engine import initialize_model_from_cfg
from nafwebsod_torch.models.detector import trainable_param_names
from nafwebsod_torch.parallel import train_step as ts
from nafwebsod_torch.solver import sgd
from nafwebsod_torch.utils import checkpoint as ckpt
from nafwebsod_torch.utils import lr_policy
from nafwebsod_torch.utils.bridge import blob_names, named_blobs

logger = logging.getLogger(__name__)


def _round_up(n, multiple):
    return ((n + multiple - 1) // multiple) * multiple


def _image_label(entry):
    """First positive image-level class; mixup partners must share it."""
    gt = np.asarray(entry['gt_classes'])
    return int(gt[gt > 0][0])


def build_minibatch(roidb, index, rng):
    """The blobs of roidb entry ``index``. With WEBLY.BAGGING_MIXUP, with
    probability 0.2 a second image of the same class is drawn and blended
    in with lambda ~ Beta(alpha, alpha)."""
    pad_rois_to = _round_up(cfg.TRAIN.BATCH_SIZE_PER_IM,
                            cfg.TPU.ROI_PAD_MULTIPLE)
    size_bucket = cfg.TPU.SIZE_BUCKET_MULTIPLE
    entry = roidb[index]
    blobs = get_minibatch(entry, rng=rng, pad_rois_to=pad_rois_to,
                          size_bucket=size_bucket)
    if (cfg.WEBLY.WEBLY_ON and cfg.WEBLY.BAGGING_MIXUP
            and rng.random_sample() > 0.8):
        label = _image_label(entry)
        same_class = [i for i, e in enumerate(roidb)
                      if _image_label(e) == label]
        partner = roidb[same_class[rng.randint(len(same_class))]]
        blobs_b = get_minibatch(partner, rng=rng, pad_rois_to=pad_rois_to,
                                size_bucket=size_bucket)
        lam = rng.beta(cfg.WEBLY.BAGGING_MIXUP_ALPHA,
                       cfg.WEBLY.BAGGING_MIXUP_ALPHA)
        blobs = mixup_blobs(blobs, blobs_b, lam, max_rois=pad_rois_to)
        if size_bucket:
            blobs['data'] = pad_image_to_bucket(
                torch.from_numpy(blobs['data'][0]), size_bucket).numpy()[None]
        blobs['mixup'] = True
    return blobs


def _cfg_yaml():
    """The cfg as YAML for the checkpoint, or None where PyYAML is not
    installed (the checkpoint's ``cfg`` entry is optional)."""
    try:
        return dump_cfg()
    except ImportError:
        return None


def create_solver(model):
    """(hyper-parameters, multipliers, state) of the cfg's solver for
    ``model``; the frozen parameters get multipliers (0, 0)."""
    hp = sgd.SGDHyperParams(momentum=cfg.SOLVER.MOMENTUM,
                            weight_decay=cfg.SOLVER.WEIGHT_DECAY,
                            iter_size=cfg.WSL.ITER_SIZE)
    names = blob_names(model)
    trainable = {names[key] for key in trainable_param_names(model)}
    params = named_blobs(model)
    mults = sgd.param_multipliers(params, trainable)
    return hp, mults, sgd.init_state(params, hp, mults)


def train_model(roidb, max_iters=None, device=None, output_dir=None,
                weights_file=None, start_iter=0):
    """Train the cfg's model on ``roidb`` for iterations ``start_iter`` to
    ``max_iters`` (SOLVER.MAX_ITER when None) on ``device`` (the card
    unless ``device='cpu'``), one image per step, cycling through the
    roidb in order. With ``output_dir`` it writes ``model_final.pkl``
    there, momentum included. Returns (model, opt_state, records), one
    record per step: {'iter', 'lr', 'loss', 'mixup', 'data_s' (host clock:
    minibatch and upload), 'step_s' (host clock: the step, up to the loss
    on the host), aux entries}."""
    max_iters = cfg.SOLVER.MAX_ITER if max_iters is None else max_iters
    model = initialize_model_from_cfg(device=device)
    hp, mults, opt_state = create_solver(model)
    if weights_file:
        ckpt.initialize_from_weights_file(
            model, weights_file, strict_shapes=False,
            momentum=opt_state['momentum'])
    rng = np.random.RandomState(cfg.RNG_SEED)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(cfg.RNG_SEED)
    records = []
    lr_prev = lr_policy.get_lr_at_iter(start_iter)
    for it in range(start_iter, max_iters):
        t0 = time.time()
        blobs = build_minibatch(roidb, it % len(roidb), rng)
        batch = ts.to_device_batch(
            ts.stack_minibatches([blobs], cfg.TPU.SIZE_BUCKET_MULTIPLE),
            model.device, cur_iter=it)
        lr = lr_policy.get_lr_at_iter(it)
        factor = sgd.momentum_correction_factor(cfg, lr, lr_prev)
        if factor is not None:
            logger.info('LR boundary at iter %d: scaling momentum by %s',
                        it, factor)
            sgd.scale_momentum(opt_state, np.float32(factor))
        lr_prev = lr
        t1 = time.time()
        loss, aux = ts.train_step(model, opt_state, batch, lr, generator,
                                  hp=hp, mults=mults)
        record = {'iter': it, 'lr': float(lr), 'loss': float(loss),
                  'mixup': bool(blobs.get('mixup', False))}
        record.update(data_s=t1 - t0, step_s=time.time() - t1)
        record.update({k: float(v) for k, v in aux.items()})
        if np.isnan(record['loss']):
            raise FloatingPointError('Loss is NaN at iter {}'.format(it))
        records.append(record)
        logger.info('iter %d lr %.6f loss %.6f', it, record['lr'],
                    record['loss'])
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        ckpt.save_weights_file(
            os.path.join(output_dir, 'model_final.pkl'), model,
            cfg_yaml=_cfg_yaml(), momentum=opt_state['momentum'])
    return model, opt_state, records
