"""The solver: the reference's ACMWeightDecayMomentumSGDUpdate op (port of
the JAX package's ``solver/sgd.py``), written out by hand and applied in
place under ``torch.no_grad()``. Not ``torch.optim.SGD``, whose momentum
form differs.

  * gradient accumulation over ``WSL.ITER_SIZE`` calls; the update fires
    on every ``iter_size``-th call, on the mean gradient;
  * weight decay added to the gradient, per parameter: biases get no decay
    and twice the learning rate, a ``_lrm10_`` infix in the blob name means
    ten times the learning rate;
  * Caffe-style momentum: ``v = mu * v + lr * lr_mult * g; p -= v`` (not
    PyTorch's ``p -= lr * v``);
  * momentum correction on learning-rate changes: when the ratio leaves the
    ``SOLVER.SCALE_MOMENTUM_THRESHOLD`` band the buffers are scaled by
    ``new_lr / old_lr`` (``scale_momentum``, driven by the training loop).

Parameters, gradients and momentum are dicts keyed by reference blob name
(``utils.bridge.named_blobs``). Frozen parameters (the conv body under
``TRAIN.FREEZE_CONV_BODY``) carry multipliers (0, 0) and are never touched.
Momentum is float32.
"""

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SGDHyperParams:
    momentum: float = 0.9
    weight_decay: float = 0.0005
    iter_size: int = 1


def param_multipliers(param_names, trainable=None):
    """blob name -> (lr_mult, decay_mult). ``trainable``: optional set of
    trainable names; the others get (0, 0)."""
    mults = {}
    for name in param_names:
        if trainable is not None and name not in trainable:
            mults[name] = (0.0, 0.0)
            continue
        if name.endswith('_b'):
            lr_mult, decay_mult = 2.0, 0.0   # bias: 2x lr, no decay
        else:
            lr_mult, decay_mult = 1.0, 1.0
        if '_lrm10_' in name:
            lr_mult *= 10.0
        mults[name] = (lr_mult, decay_mult)
    return mults


def _is_frozen(mult):
    return mult[0] == 0.0 and mult[1] == 0.0


def init_state(params, hp, mults=None):
    """Zero momentum buffers for every parameter, the call counter, and a
    gradient accumulator when ``iter_size > 1`` (for the parameters that
    are not frozen by ``mults``)."""
    state = {'momentum': {k: torch.zeros_like(v, dtype=torch.float32)
                          for k, v in params.items()},
             'it': 0}
    if hp.iter_size > 1:
        state['grad_acc'] = {
            k: torch.zeros_like(v, dtype=torch.float32)
            for k, v in params.items()
            if mults is None or not _is_frozen(mults[k])}
    return state


@torch.no_grad()
def _apply(params, grads, momentum, lr, hp, mults):
    for name, p in params.items():
        lr_mult, decay_mult = mults[name]
        if _is_frozen(mults[name]):
            continue
        g = grads[name].float().add(p, alpha=hp.weight_decay * decay_mult)
        v = momentum[name]
        v.mul_(hp.momentum).add_(g, alpha=float(lr) * lr_mult)
        p.sub_(v)


@torch.no_grad()
def update(params, grads, state, lr, hp, mults):
    """One call of the solver, in place on ``params`` and ``state``. With
    ``iter_size == 1`` it is a plain update; otherwise gradients accumulate
    and the update fires on every ``iter_size``-th call. ``grads`` holds
    the parameters that are not frozen."""
    state['it'] += 1
    if hp.iter_size == 1:
        _apply(params, grads, state['momentum'], lr, hp, mults)
        return
    acc = state['grad_acc']
    for name, g in grads.items():
        acc[name].add_(g)
    if state['it'] % hp.iter_size == 0:
        mean = {k: v / float(hp.iter_size) for k, v in acc.items()}
        _apply(params, mean, state['momentum'], lr, hp, mults)
        for v in acc.values():
            v.zero_()


@torch.no_grad()
def scale_momentum(state, correction):
    """Momentum correction on a learning-rate step: v *= new / old."""
    for v in state['momentum'].values():
        v.mul_(float(correction))


def momentum_correction_factor(cfg, lr_new, lr_old):
    """The factor to apply to the momentum buffers when the learning rate
    goes from ``lr_old`` to ``lr_new``, or None inside the threshold
    band."""
    if not cfg.SOLVER.SCALE_MOMENTUM or lr_old <= 0:
        return None
    ratio = lr_new / lr_old
    thresh = cfg.SOLVER.SCALE_MOMENTUM_THRESHOLD
    if ratio > thresh or ratio < 1.0 / thresh:
        return ratio
    return None
