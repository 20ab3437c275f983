"""Segmentation mask utilities (the port's own copy of the RLE part of the
JAX package's ``utils/segms.py``): the COCO-compatible run-length codec
for binary masks and mask IoU, numpy only. The polygon functions
(rasterisation with ``cv2.fillPoly``, flipping, polygon boxes) are not
copied yet: they serve segm evaluation and mask targets, which are not
ported.
"""

import numpy as np


def mask_iou(a, b):
    """IoU of two binary masks."""
    inter = np.logical_and(a > 0.5, b > 0.5).sum()
    union = np.logical_or(a > 0.5, b > 0.5).sum()
    return inter / union if union else 0.0


# COCO-compatible RLE (the semantics of pycocotools' maskApi.c rleEncode and
# rleToString), in numpy: the segms of detections.pkl are readable by the
# COCO API without pycocotools.

def _rle_counts_to_string(cnts):
    """LEB128-ish 6-bit packing with delta coding (maskApi.c rleToString)."""
    s = bytearray()
    for i, x in enumerate(cnts):
        x = int(x)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(c + 48)
    return bytes(s)


def _rle_string_to_counts(s):
    cnts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def mask_to_rle(mask):
    """Binary (H, W) mask -> COCO compressed RLE dict
    {'size': [H, W], 'counts': bytes} (column-major runs starting with the
    zero run, exactly pycocotools' layout)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).flatten(order='F')
    # run-length over alternating values starting at 0
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds)
    if flat.size and flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return {'size': [int(h), int(w)],
            'counts': _rle_counts_to_string(runs)}


def rle_to_mask(rle):
    """Inverse of mask_to_rle."""
    h, w = rle['size']
    counts = rle['counts']
    if isinstance(counts, str):
        # compressed counts arrive as str when the RLE came through json
        counts = _rle_string_to_counts(counts.encode('utf-8'))
    elif isinstance(counts, (bytes, bytearray)):
        counts = _rle_string_to_counts(bytes(counts))
    flat = np.zeros((h * w,), np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape((w, h)).T
