"""Training roidb assembly (the port's own copy of the JAX package's
``data/roidb.py``; pure numpy): load one or more datasets (optionally with
precomputed proposals), append horizontally-flipped copies, drop entries a
WSL trainer cannot use, and log a class histogram."""

import logging

import numpy as np

from nafwebsod_torch.core.config import cfg
from nafwebsod_torch.data.json_dataset import JsonDataset

logger = logging.getLogger(__name__)


def _as_tuple(x):
    return (x,) if isinstance(x, str) else tuple(x)


def _hflip_entry(entry):
    """A horizontally-flipped copy of one roidb entry. Only the geometry is
    rewritten (x1 / x2 mirrored about the image width, inclusive pixels);
    everything else is shared with the source entry. The pixels are flipped
    later, when the minibatch is made."""
    w = entry['width']
    flipped = dict(entry, flipped=True)
    x1, y1, x2, y2 = np.split(entry['boxes'], 4, axis=1)
    flipped['boxes'] = np.concatenate(
        [w - x2 - 1, y1, w - x1 - 1, y2], axis=1)
    if np.any(flipped['boxes'][:, 2] < flipped['boxes'][:, 0]):
        raise ValueError(
            f"flip produced x2 < x1 for image {entry.get('id', '?')}; "
            "check box coordinates against the recorded width")
    return flipped


def extend_with_flipped_entries(roidb):
    """Append a flipped copy of every entry to ``roidb`` in place."""
    roidb.extend([_hflip_entry(e) for e in roidb])


def _usable_for_wsl_training(entry):
    """An entry trains only if it carries at least one box and a
    non-background image label."""
    return len(entry['boxes']) > 0 and bool((entry['gt_classes'] > 0).any())


def filter_for_training(roidb):
    """Drop entries with no usable RoIs; log how many were removed."""
    kept = [e for e in roidb if _usable_for_wsl_training(e)]
    logger.info('Filtered %d roidb entries: %d -> %d',
                len(roidb) - len(kept), len(roidb), len(kept))
    return kept


def _log_class_histogram(roidb):
    if not roidb:
        return
    num_classes = roidb[0]['gt_overlaps'].shape[1]
    labels = [
        e['gt_classes'][(e['gt_classes'] > 0) & (e['is_crowd'] == 0)]
        for e in roidb
    ]
    hist = np.bincount(np.concatenate(labels),
                       minlength=num_classes)[:num_classes]
    logger.debug('Ground-truth class histogram: %s (total %d)',
                 hist, int(hist.sum()))


def combined_roidb_for_training(dataset_names, proposal_files):
    """The training roidb across datasets: each is loaded with ground
    truth, optionally with precomputed proposals, and (under
    ``TRAIN.USE_FLIPPED``) doubled with flipped copies; the concatenation
    is then filtered for trainability. The entries carry the image's path
    under ``'image'``."""
    names = _as_tuple(dataset_names)
    props = (_as_tuple(proposal_files) if proposal_files
             else (None,) * len(names))
    if len(names) != len(props):
        raise ValueError(
            f'{len(names)} dataset(s) but {len(props)} proposal file(s)')

    combined = []
    for name, proposal_file in zip(names, props):
        ds = JsonDataset(name)
        roidb = ds.get_roidb(
            gt=True,
            proposal_file=proposal_file,
            crowd_filter_thresh=cfg.TRAIN.CROWD_FILTER_THRESH,
        )
        if cfg.TRAIN.USE_FLIPPED:
            logger.info('Appending horizontally-flipped training examples...')
            extend_with_flipped_entries(roidb)
        logger.info('Loaded dataset: %s (%d entries)', ds.name, len(roidb))
        combined += roidb

    combined = filter_for_training(combined)
    _log_class_histogram(combined)
    return combined
