"""Host-side (numpy) box operations the dataset layer calls (the port's own
copy of that subset of the JAX package's ``ops/boxes.py``). All box math
uses the Detectron legacy "+ 1" width / height convention
(w = x2 - x1 + 1). The device-side operations live in ``ops/jbox.py``."""

import numpy as np


def _wh(boxes):
    """1-based widths / heights of (N, 4) xyxy boxes."""
    return (boxes[:, 2] - boxes[:, 0] + 1.0,
            boxes[:, 3] - boxes[:, 1] + 1.0)


def boxes_area(boxes):
    w, h = _wh(boxes)
    return w * h


def bbox_overlaps(boxes, query_boxes):
    """IoU matrix between (N, 4) and (K, 4) boxes, in float64."""
    b = np.ascontiguousarray(boxes, dtype=np.float64)
    q = np.ascontiguousarray(query_boxes, dtype=np.float64)
    iw = (np.minimum(b[:, None, 2], q[None, :, 2]) -
          np.maximum(b[:, None, 0], q[None, :, 0]) + 1).clip(min=0)
    ih = (np.minimum(b[:, None, 3], q[None, :, 3]) -
          np.maximum(b[:, None, 1], q[None, :, 1]) + 1).clip(min=0)
    inter = iw * ih
    union = boxes_area(b)[:, None] + boxes_area(q)[None, :] - inter
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(inter > 0, inter / union, 0.0)


def xywh_to_xyxy(xywh):
    """(x, y, w, h) -> (x1, y1, x2, y2)."""
    if isinstance(xywh, (list, tuple)):
        assert len(xywh) == 4
        x1, y1, w, h = xywh
        return (x1, y1, x1 + np.maximum(0., w - 1.),
                y1 + np.maximum(0., h - 1.))
    if isinstance(xywh, np.ndarray):
        far = xywh[:, 0:2] + np.maximum(0, xywh[:, 2:4] - 1)
        return np.hstack((xywh[:, 0:2], far))
    raise TypeError('Argument xywh must be a list, tuple, or numpy array.')


def filter_small_boxes(boxes, min_size):
    """Indices of boxes with BOTH 1-based sides strictly > min_size."""
    w, h = _wh(boxes)
    return np.where((w > min_size) & (h > min_size))[0]


def clip_xyxy_to_image(x1, y1, x2, y2, height, width):
    return (np.clip(x1, 0., width - 1.), np.clip(y1, 0., height - 1.),
            np.clip(x2, 0., width - 1.), np.clip(y2, 0., height - 1.))


def unique_boxes(boxes, scale=1.0):
    """Indices of unique boxes after quantizing coords by ``scale``."""
    digits = np.round(boxes * scale).dot([1, 1e3, 1e6, 1e9])
    _, index = np.unique(digits, return_index=True)
    return np.sort(index)
