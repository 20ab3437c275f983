#!/usr/bin/env python
"""Train a model with the PyTorch / CUDA package (the counterpart of
``tools/train_net.py``): a cfg (a YAML file, or the name of an in-code
config of ``nafwebsod_torch.core.config``: FLAGSHIP, CSC, CONTEXT, SEG,
SEG_FCN) with ``KEY VALUE`` overrides, then seed, train, and test the
final model and every snapshot on TEST.DATASETS.

    python tools/train_net_torch.py --cfg <cfg.yaml | FLAGSHIP> \\
        [--device cpu] [--skip-test] [KEY VALUE ...]

It trains on the card unless ``--device cpu``; without a card and without
``--device cpu`` it raises.
"""

import argparse
import logging
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nafwebsod_torch.core import config
from nafwebsod_torch.core.config import (assert_and_infer_cfg, cfg,
                                         merge_cfg_from_cfg,
                                         merge_cfg_from_file,
                                         merge_cfg_from_list)
from nafwebsod_torch.engine import test_engine
from nafwebsod_torch.engine import train as train_engine

IN_CODE_CONFIGS = ('FLAGSHIP', 'CSC', 'CONTEXT', 'SEG', 'SEG_FCN')

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Train a network')
    parser.add_argument('--cfg', dest='cfg_file', default=None,
                        help='a YAML file, or one of ' +
                        ', '.join(IN_CODE_CONFIGS))
    parser.add_argument('--device', default=None,
                        help="'cpu' to run without a card")
    parser.add_argument('--skip-test', dest='skip_test', action='store_true',
                        help='do not test the trained models')
    parser.add_argument('opts', default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None, images=None):
    """Returns (checkpoints, training records, {checkpoint key: test
    results}). ``images``: optionally {image id: (H, W, 3) uint8 BGR
    array}, the pixels of the training and test images in place of their
    files."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format='%(levelname)s %(name)s: %(message)s')
    if args.cfg_file in IN_CODE_CONFIGS:
        merge_cfg_from_cfg(getattr(config, args.cfg_file))
    elif args.cfg_file is not None:
        merge_cfg_from_file(args.cfg_file)
    if args.opts:
        merge_cfg_from_list(args.opts)
    assert_and_infer_cfg()
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)

    checkpoints, records = train_engine.train_model(device=args.device,
                                                    images=images)
    results = {}
    if not args.skip_test:
        for key in ['final'] + sorted(k for k in checkpoints
                                      if k != 'final'):
            results[key] = test_model(checkpoints[key], args.device, images)
    return checkpoints, records, results


def test_model(model_file, device, images):
    """Test ``model_file`` on TEST.DATASETS."""
    logger.info('Testing %s', model_file)
    cfg.immutable(False)
    cfg.TEST.WEIGHTS = model_file
    cfg.immutable(True)
    return test_engine.run_inference(model_file, check_expected_results=True,
                                     device=device, images=images)


if __name__ == '__main__':
    main()
