"""Checkpoint I/O in the reference pkl schema (port of the JAX package's
``utils/checkpoint.py``).

Schema: ``{'blobs': {name: ndarray}, 'cfg': yaml_str}``, conv weights OIHW
and fc weights (out, in) -- the port's own layouts, so no transpose happens
at this boundary. A parameter named ``'_[tag]_foo'`` is initialised from
blob ``foo`` when its own blob is missing: the noisy fc6/fc7 tower shares
the clean tower's initialisation this way. The solver's momentum is saved
as ``<name>_momentum`` blobs beside the weights, so a saved step reloads
bitwise; ``__preserve__/`` blobs are ignored.
"""

import logging
import os
import re

import numpy as np
import torch

from nafwebsod_torch.utils import io as io_utils
from nafwebsod_torch.utils.bridge import blob_names

logger = logging.getLogger(__name__)

_ALIAS_RE = re.compile(r'^_\[.*\]_')


def unscope_name(name):
    """Strip a 'gpu_<i>/' device scope if present (reference blob names)."""
    return name.split('/')[-1] if name.startswith('gpu_') else name


def load_weights_pkl(path):
    """Read a reference-format pkl; returns (blobs, saved_cfg)."""
    data = io_utils.load_object(path)
    if isinstance(data, dict) and 'blobs' in data:
        return data['blobs'], data.get('cfg', None)
    return data, None


@torch.no_grad()
def initialize_from_weights_file(model, path, strict_shapes=True,
                                 momentum=None):
    """Copy the pkl's blobs into ``model``'s parameters, and its momentum
    blobs into ``momentum`` (the solver state's {blob name: tensor}) when
    that is given; an aliased parameter takes no momentum. Returns the
    blob names of the parameters the file did not provide."""
    blobs, _ = load_weights_pkl(path)
    blobs = {unscope_name(k): v for k, v in blobs.items()}
    state = model.state_dict()
    unmatched = []
    for key, name in blob_names(model).items():
        src = name
        if src not in blobs and _ALIAS_RE.match(src):
            src = _ALIAS_RE.sub('', src)  # '_[noisy]_fc6_w' -> 'fc6_w'
        if src not in blobs:
            unmatched.append(name)
            continue
        arr = np.asarray(blobs[src])
        if tuple(arr.shape) != tuple(state[key].shape):
            msg = 'Shape mismatch for {}: checkpoint {} vs model {}'.format(
                name, arr.shape, tuple(state[key].shape))
            if strict_shapes:
                raise ValueError(msg)
            logger.warning(msg)
            unmatched.append(name)
            continue
        state[key].copy_(torch.tensor(arr))
        if (momentum is not None and src == name
                and name + '_momentum' in blobs):
            momentum[name].copy_(torch.tensor(
                np.asarray(blobs[name + '_momentum'])))
    if unmatched:
        logger.info('Params not found in %s: %s', path, unmatched)
    return unmatched


def save_weights_file(path, model, cfg_yaml=None, momentum=None):
    """Write ``model``'s parameters, and the solver's ``momentum``
    ({blob name: tensor}) when given, as a reference-format pkl."""
    state = model.state_dict()
    blobs = {name: state[key].detach().cpu().numpy()
             for key, name in blob_names(model).items()}
    if momentum:
        for name, value in momentum.items():
            blobs[name + '_momentum'] = value.detach().cpu().numpy()
    out = {'blobs': blobs}
    if cfg_yaml is not None:
        out['cfg'] = cfg_yaml
    io_utils.save_object(out, path)


def find_checkpoint_for_resume(output_dir):
    """The AUTO_RESUME scan: (model_final.pkl, None) when training has
    finished, else (the newest model_iter<N>.pkl, N + 1), else (None, 0)."""
    final_path = os.path.join(output_dir, 'model_final.pkl')
    if os.path.exists(final_path):
        return final_path, None
    best_iter, best_path = -1, None
    if os.path.isdir(output_dir):
        for fname in os.listdir(output_dir):
            m = re.match(r'^model_iter(\d+)\.pkl$', fname)
            if m and int(m.group(1)) > best_iter:
                best_iter = int(m.group(1))
                best_path = os.path.join(output_dir, fname)
    if best_path is None:
        return None, 0
    return best_path, best_iter + 1
