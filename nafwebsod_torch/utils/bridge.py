"""The one map between the port's module paths and the reference's blob
names, and the bridge from JAX-package parameters to the port.

Blob names such as ``_[noisy]_fc6_w`` are not valid attribute names, so
the port's modules are named for Python and this table names their
parameters for the reference pkl schema (``utils/checkpoint.py``) and for
the JAX package's parameter dicts (``params_from_jax``).
"""

import numpy as np
import torch

from nafwebsod_torch.models.vgg16 import VGG16_STAGES

_HEAD_LAYERS = {
    'head.clean.fc6': 'fc6',
    'head.clean.fc7': 'fc7',
    'head.noisy.fc6': '_[noisy]_fc6',
    'head.noisy.fc7': '_[noisy]_fc7',
    'head.fc8c': 'fc8c',
    'head.fc8d': 'fc8d',
    'head.noisy_fc8c': 'noisy_fc8c',
    'head.noisy_fc8d': 'noisy_fc8d',
}
# the context head's detection layer, in place of fc8d
_CONTEXT_LAYERS = {'head.fc8d_frame': 'fc8d_frame'}


def _layer_names(layers):
    names = {}
    for path, blob in layers.items():
        names[path + '.weight'] = blob + '_w'
        names[path + '.bias'] = blob + '_b'
    return names


def _body_layers():
    return {'body.' + name: name
            for stage in VGG16_STAGES for name, _, _ in stage}


def blob_names(model=None):
    """{Detector state-dict key: reference blob name}: of the noise-aware
    model, or of ``model``'s own parameters (the plain 2fc head has no
    noisy tower; the context head has ``fc8d_frame`` and no ``fc8d``)."""
    if model is None:
        return _layer_names({**_body_layers(), **_HEAD_LAYERS})
    have = {key.rsplit('.', 1)[0] for key in model.state_dict()}
    return _layer_names({
        path: blob for path, blob in {**_body_layers(), **_HEAD_LAYERS,
                                      **_CONTEXT_LAYERS}.items()
        if path in have})


def params_from_jax(params):
    """A Detector state dict from a JAX-package parameter dict (numpy
    arrays: HWIO convs, (in, out) FCs), for the blobs ``params`` holds. The
    port's layouts are the reference's: OIHW convs, (out, in) FCs."""
    state = {}
    names = _layer_names({**_body_layers(), **_HEAD_LAYERS,
                          **_CONTEXT_LAYERS})
    for path, blob in names.items():
        if blob not in params:
            continue
        arr = np.asarray(params[blob], np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        state[path] = torch.tensor(arr)
    return state


def named_blobs(model):
    """{reference blob name: parameter tensor} of ``model``: the keys of
    the solver's state and of a checkpoint's blobs."""
    params = dict(model.named_parameters())
    return {blob: params[key] for key, blob in blob_names(model).items()}


def state_to_jax_names(tensors):
    """A {blob name: tensor} dict in the port's layouts (parameters,
    gradients or momentum) as numpy arrays in the JAX package's: HWIO
    convs, (in, out) FCs."""
    out = {}
    for blob, value in tensors.items():
        arr = value.detach().cpu().float().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        elif arr.ndim == 2:
            arr = arr.T
        out[blob] = np.ascontiguousarray(arr)
    return out
