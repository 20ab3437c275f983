"""Checkpoint I/O in the reference pkl schema (port of the JAX package's
``utils/checkpoint.py``).

Schema: ``{'blobs': {name: ndarray}, 'cfg': yaml_str}``, conv weights OIHW
and fc weights (out, in) -- the port's own layouts, so no transpose happens
at this boundary. A parameter named ``'_[tag]_foo'`` is initialised from
blob ``foo`` when its own blob is missing: the noisy fc6/fc7 tower shares
the clean tower's initialisation this way. Momentum and ``__preserve__/``
blobs are training state; inference ignores them.
"""

import logging
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
def initialize_from_weights_file(model, path, strict_shapes=True):
    """Copy the pkl's blobs into ``model``'s parameters. Returns the blob
    names of the parameters the file did not provide."""
    blobs, _ = load_weights_pkl(path)
    blobs = {unscope_name(k): v for k, v in blobs.items()}
    state = model.state_dict()
    unmatched = []
    for key, name in blob_names().items():
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
    if unmatched:
        logger.info('Params not found in %s: %s', path, unmatched)
    return unmatched


def save_weights_file(path, model, cfg_yaml=None):
    """Write ``model``'s parameters as a reference-format pkl."""
    state = model.state_dict()
    blobs = {name: state[key].detach().cpu().numpy()
             for key, name in blob_names().items()}
    out = {'blobs': blobs}
    if cfg_yaml is not None:
        out['cfg'] = cfg_yaml
    io_utils.save_object(out, path)
