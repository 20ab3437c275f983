"""Learning-rate schedules (the port's own copy of the JAX package's
``utils/lr_policy.py``): policies steps_with_decay / steps_with_lrs / step /
cosine_decay / exp_decay plus linear or constant warm-up. Pure host Python
over the global cfg; each iteration's scalar is handed to the train step.
"""

import bisect

import numpy as np

from nafwebsod_torch.core.config import cfg


def get_lr_at_iter(it):
    """LR at iteration ``it``, warm-up applied."""
    lr = get_lr_func()(it)
    span = cfg.SOLVER.WARM_UP_ITERS
    if it < span:
        base = cfg.SOLVER.WARM_UP_FACTOR
        mode = cfg.SOLVER.WARM_UP_METHOD
        if mode == 'linear':
            frac = it / span
            lr *= base * (1 - frac) + frac
        elif mode == 'constant':
            lr *= base
        else:
            raise KeyError('Unknown SOLVER.WARM_UP_METHOD: {}'.format(mode))
    return np.float32(lr)


def _steps_index(cur_iter):
    """Index of the SOLVER.STEPS segment containing ``cur_iter``."""
    steps = list(cfg.SOLVER.STEPS)
    assert steps and steps[0] == 0, (
        'SOLVER.STEPS must be non-empty and start with 0 (got {}): an '
        'index of -1 before the first step would silently apply '
        'GAMMA**-1'.format(cfg.SOLVER.STEPS))
    return bisect.bisect_right(steps, cur_iter) - 1


def lr_func_steps_with_decay(cur_iter):
    """BASE_LR * GAMMA ** step_index — the flagship schedule
    (``configs/flickr_voc/na_wsddn_V-16-C5_1x.yaml`` uses STEPS [0, 150000])."""
    return cfg.SOLVER.BASE_LR * cfg.SOLVER.GAMMA ** _steps_index(cur_iter)


def lr_func_steps_with_lrs(cur_iter):
    """Explicit LR per step range: SOLVER.STEPS paired with SOLVER.LRS."""
    return cfg.SOLVER.LRS[_steps_index(cur_iter)]


def lr_func_step(cur_iter):
    return (cfg.SOLVER.BASE_LR *
            cfg.SOLVER.GAMMA ** (cur_iter // cfg.SOLVER.STEP_SIZE))


def lr_func_cosine_decay(cur_iter):
    return 0.5 * cfg.SOLVER.BASE_LR * (
        1.0 + np.cos(np.pi * float(cur_iter) / cfg.SOLVER.MAX_ITER))


def lr_func_exp_decay(cur_iter):
    # GAMMA is the final/initial LR ratio
    return cfg.SOLVER.BASE_LR * cfg.SOLVER.GAMMA ** (
        float(cur_iter) / cfg.SOLVER.MAX_ITER)


_POLICIES = {
    'steps_with_decay': lr_func_steps_with_decay,
    'steps_with_lrs': lr_func_steps_with_lrs,
    'step': lr_func_step,
    'cosine_decay': lr_func_cosine_decay,
    'exp_decay': lr_func_exp_decay,
}


def get_lr_func():
    try:
        return _POLICIES[cfg.SOLVER.LR_POLICY]
    except KeyError:
        raise NotImplementedError(
            'Unknown LR policy: {}'.format(cfg.SOLVER.LR_POLICY))
