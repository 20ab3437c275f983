#!/usr/bin/env python
"""Test a trained model on one or more datasets with the PyTorch / CUDA
package (the counterpart of ``tools/test_net.py``): YAML cfg + CLI
overrides, ``TEST.WEIGHTS``, ``--device`` (the card unless ``cpu``).

    python tools/test_net_torch.py --cfg <cfg.yaml> [--device cpu] \\
        TEST.WEIGHTS <model.pkl> [KEY VALUE ...]
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nafwebsod_torch.core.config import (assert_and_infer_cfg, cfg,
                                         merge_cfg_from_file,
                                         merge_cfg_from_list)
from nafwebsod_torch.engine import test_engine


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Test a detection network')
    parser.add_argument('--cfg', dest='cfg_file', default=None)
    parser.add_argument('--device', default=None,
                        help="'cpu' to run without a card")
    parser.add_argument('--multi-gpu-testing', dest='multi_gpu_testing',
                        action='store_true')
    parser.add_argument('--range', dest='range', type=int, nargs=2,
                        default=None, help='start end image index range')
    parser.add_argument('opts', default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format='%(levelname)s %(name)s: %(message)s')
    if args.cfg_file is not None:
        merge_cfg_from_file(args.cfg_file)
    if args.opts:
        merge_cfg_from_list(args.opts)
    assert_and_infer_cfg()
    assert cfg.TEST.WEIGHTS, 'TEST.WEIGHTS must be set'
    return test_engine.run_inference(
        cfg.TEST.WEIGHTS,
        ind_range=tuple(args.range) if args.range else None,
        multi_gpu_testing=args.multi_gpu_testing,
        check_expected_results=True, device=args.device)


if __name__ == '__main__':
    main()
