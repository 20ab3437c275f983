"""Training on one card (port of the JAX package's
``engine/train.py``): the training roidb, AUTO_RESUME, the initial
weights, the threaded loader, the learning-rate schedule with momentum
correction at its boundaries, the train step, ``json_stats:`` lines,
periodic snapshots, the NaN guard and ``model_final.pkl``.

``train_model`` is the job a user starts (``tools/train_net_torch.py``);
``train_loop`` is its loop over a built model and solver, for callers that
keep the model.

A roidb is a list of entries, each a dict with ``'image'`` (an (H, W, 3)
uint8 BGR array or the path of an image file), ``'width'`` and
``'height'``, ``'boxes'`` (R, 4) proposals sorted by objectness,
``'obn_scores'`` (R, 1) and ``'gt_classes'`` (the image's classes, > 0);
``data/roidb.py:combined_roidb_for_training`` builds it from the cfg's
datasets. Not ported: the ``WSL.SAMPLE`` visualisation dumps.
"""

import logging
import os
import threading
import time

import numpy as np
import torch

from nafwebsod_torch.core.config import (cfg, dump_cfg_or_none,
                                         get_output_dir)
from nafwebsod_torch.data.loader import RoIDataLoader
from nafwebsod_torch.data.roidb import combined_roidb_for_training
from nafwebsod_torch.engine.test_engine import initialize_model_from_cfg
from nafwebsod_torch.models.detector import trainable_param_names
from nafwebsod_torch.parallel import train_step as ts
from nafwebsod_torch.solver import sgd
from nafwebsod_torch.utils import checkpoint as ckpt
from nafwebsod_torch.utils import lr_policy
from nafwebsod_torch.utils.bridge import blob_names, named_blobs
from nafwebsod_torch.utils.training_stats import TrainingStats

logger = logging.getLogger(__name__)


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


def save_checkpoint(path, model, opt_state):
    """``model``'s weights and the solver's momentum as a reference pkl."""
    logger.info('Saving checkpoint to %s', path)
    ckpt.save_weights_file(path, model, cfg_yaml=dump_cfg_or_none(),
                           momentum=opt_state['momentum'])
    return path


def train_loop(model, solver, roidb, start_iter=0, max_iters=None,
               output_dir=None, checkpoints=None):
    """Iterations ``start_iter`` to ``max_iters`` (SOLVER.MAX_ITER when
    None) of ``model`` with ``solver`` (``create_solver``), in place, on
    minibatches of ``roidb`` from a ``RoIDataLoader``. With ``output_dir``
    it writes ``model_iter<N>.pkl`` after every TRAIN.SNAPSHOT_ITERS-th
    iteration N but the last, into ``checkpoints[N]``; on a NaN loss it
    writes ``model_nan.pkl`` of the state before that step, then raises
    FloatingPointError. A loader thread's failure raises here.

    Returns one record per step: {'iter', 'lr', 'loss', 'mixup',
    'queue_size' (minibatches waiting when the step took its own),
    'data_s' (host clock: the wait on the loader's queue), 'upload_s' (the
    copy to the device), 'step_s' (the step, up to the loss on the host),
    aux entries}."""
    max_iters = max_iters or cfg.SOLVER.MAX_ITER
    hp, mults, opt_state = solver
    if cfg.WSL.SAMPLE:
        logger.info('WSL.SAMPLE: the training visualisation dumps are not '
                    'ported; training without them')
    generator = torch.Generator(device=model.device)
    generator.manual_seed(cfg.RNG_SEED)
    stats = TrainingStats(device=model.device)
    snapshot_iters = max(cfg.TRAIN.SNAPSHOT_ITERS, 1)
    records = []
    loader = RoIDataLoader(roidb)
    if threading.current_thread() is threading.main_thread():
        loader.register_sigint_handler()
    try:
        loader.start(prefill=True)
        lr_prev = lr_policy.get_lr_at_iter(start_iter)
        for it in range(start_iter, max_iters):
            stats.IterTic()
            t0 = time.time()
            queue_size = loader.queue_size()
            blobs = loader.get()
            t1 = time.time()
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
            t2 = time.time()
            try:
                loss, aux = ts.train_step(model, opt_state, batch, lr,
                                          generator, hp=hp, mults=mults)
            except FloatingPointError:
                if output_dir is not None:
                    save_checkpoint(os.path.join(output_dir,
                                                 'model_nan.pkl'),
                                    model, opt_state)
                raise FloatingPointError('Loss is NaN at iter {}'.format(it))
            record = {'iter': it, 'lr': float(lr), 'loss': float(loss),
                      'mixup': bool(blobs.get('mixup', False)),
                      'queue_size': queue_size, 'data_s': t1 - t0,
                      'upload_s': t2 - t1, 'step_s': time.time() - t2}
            record.update({k: float(v) for k, v in aux.items()})
            records.append(record)
            stats.UpdateIterStats(record['loss'],
                                  {k: record[k] for k in aux})
            stats.IterToc()
            stats.LogIterStats(it, lr, queue_size=loader.queue_size())
            if (output_dir is not None and (it + 1) % snapshot_iters == 0
                    and it + 1 < max_iters):
                path = save_checkpoint(os.path.join(
                    output_dir, 'model_iter{}.pkl'.format(it)), model,
                    opt_state)
                if checkpoints is not None:
                    checkpoints[it] = path
    finally:
        loader.shutdown()
    return records


def train_model(roidb=None, max_iters=None, device=None, images=None):
    """Train the cfg's model on ``device`` (the card unless
    ``device='cpu'``) into ``get_output_dir(TRAIN.DATASETS)``. Without
    ``roidb`` it is built from TRAIN.DATASETS and TRAIN.PROPOSAL_FILES;
    ``images`` optionally maps image ids to (H, W, 3) uint8 BGR arrays
    handed over in place of the image files. Under TRAIN.AUTO_RESUME an
    existing ``model_final.pkl`` ends the job at once and the newest
    ``model_iter<N>.pkl`` resumes it at N + 1, weights and momentum;
    otherwise it starts from TRAIN.WEIGHTS (seeded random weights when
    empty). Returns (checkpoints {iter or 'final': path}, records of
    ``train_loop``)."""
    output_dir = get_output_dir(cfg.TRAIN.DATASETS, training=True)
    checkpoints = {}
    weights_file, start_iter = cfg.TRAIN.WEIGHTS, 0
    if cfg.TRAIN.AUTO_RESUME:
        path, it = ckpt.find_checkpoint_for_resume(output_dir)
        if path is not None and it is None:
            logger.info('model_final.pkl exists; skipping training')
            checkpoints['final'] = path
            return checkpoints, []
        if path is not None:
            logger.info('Resuming from %s (iter %d)', path, it)
            weights_file, start_iter = path, it
    model = initialize_model_from_cfg(device=device)
    solver = create_solver(model)
    if weights_file:
        unmatched = ckpt.initialize_from_weights_file(
            model, weights_file, strict_shapes=False,
            momentum=solver[2]['momentum'])
        if unmatched:
            logger.info('Randomly initialized: %s', sorted(unmatched))
    if roidb is None:
        roidb = combined_roidb_for_training(cfg.TRAIN.DATASETS,
                                            cfg.TRAIN.PROPOSAL_FILES)
        if images is not None:
            for entry in roidb:
                entry['image'] = images[entry['id']]
    records = train_loop(model, solver, roidb, start_iter, max_iters,
                         output_dir, checkpoints)
    checkpoints['final'] = save_checkpoint(
        os.path.join(output_dir, 'model_final.pkl'), model, solver[2])
    return checkpoints, records
