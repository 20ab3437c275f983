"""Why the flagship's train step is slow while the loader threads fill
their queue: the GIL the threads take, or the cores their CPU ops take.

    python3 scripts/port_loader_ab.py [--steps 96] [--rounds 2]

Run it from the root of the checkout, on a card. It builds the RoIPoolF
kernel, writes chip_smoke.py phase 13's synthetic flickr_voc-style
training set (8 VOC-sized images with ~2000 proposals, 16 entries with the
flipped ones) and trains the flagship at full width from its seed for
``--steps`` steps through ``engine/train.py:train_loop`` (the loader's
queue of DATA_LOADER.MINIBATCH_QUEUE_SIZE 64, as in phase 13), under four
variants, in turns (A B C D, then D C B A, ``--rounds`` times in all):

  * A: 4 loader threads, each with torch's default intra-op thread count,
    one a core (phase 13's setting);
  * B: 4 loader threads, each calling ``torch.set_num_threads(1)`` first;
  * C: 1 loader thread, default intra-op;
  * D: 1 loader thread, intra-op 1.

A and B differ only in the threads the loader's torch CPU ops (the
resize) may start; if the slow steps came from the GIL alone, B would
stay as slow as A.

Per step it reads the step time (host clock, to the loss on the host),
the cores the process used during it (user + system CPU time over the
step's wall time) and the main thread's own CPU time over that wall
time; per minibatch, its build time inside its loader thread. A step's
iteration is its wait on the queue, its upload and the step. Steps are
summarized as those taken while the queue was filling (fewer than 64
waiting at the step's start), those after, and the second half of each
run (where the four-thread variants reach their steady state); the
first step of a run is left out of the first two. The last lines are a
JSON summary per variant, torch's parallel_info, and the card's
``nvidia-smi --query-gpu=name,power.limit`` line. Exits non-zero
without a card.
"""

import argparse
import json
import os
import resource
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nafwebsod_torch.core.config import (FLAGSHIP, cfg,  # noqa: E402
                                         merge_cfg_from_cfg, reset_cfg)
from nafwebsod_torch.data import loader as loader_lib  # noqa: E402
from nafwebsod_torch.data.roidb import (  # noqa: E402
    combined_roidb_for_training)
from nafwebsod_torch.engine import train as train_engine  # noqa: E402
from nafwebsod_torch.engine.test_engine import (  # noqa: E402
    initialize_model_from_cfg)
from nafwebsod_torch.parallel import train_step as ts  # noqa: E402

VARIANTS = {'A': (4, False), 'B': (4, True), 'C': (1, False),
            'D': (1, True)}


def configure(train_props):
    reset_cfg()
    merge_cfg_from_cfg(FLAGSHIP)
    cfg.TRAIN.WEIGHTS = ''
    cfg.TRAIN.DATASETS = (chip_smoke.JOB_DATASET,)
    cfg.TRAIN.PROPOSAL_FILES = (train_props,)
    cfg.SOLVER.BASE_LR = chip_smoke.TRAIN_BASE_LR


def cpu_s(who):
    use = resource.getrusage(who)
    return use.ru_utime + use.ru_stime


def run_variant(name, roidb, steps, default_threads):
    """``steps`` steps of a fresh flagship under variant ``name``."""
    threads, single = VARIANTS[name]
    cfg.DATA_LOADER.NUM_THREADS = threads
    per_step, builds = [], []
    real_step = ts.train_step
    real_thread = loader_lib.RoIDataLoader._loader_thread
    real_build = loader_lib.RoIDataLoader.build_minibatch

    def step(*args, **kwargs):
        torch.cuda.synchronize()
        w0 = time.time()
        c0, m0 = cpu_s(resource.RUSAGE_SELF), cpu_s(resource.RUSAGE_THREAD)
        out = real_step(*args, **kwargs)
        w1 = time.time()
        c1, m1 = cpu_s(resource.RUSAGE_SELF), cpu_s(resource.RUSAGE_THREAD)
        per_step.append({'cores': (c1 - c0) / (w1 - w0),
                         'main_cpu': (m1 - m0) / (w1 - w0)})
        return out

    def loader_thread(self):
        if single:
            torch.set_num_threads(1)
        return real_thread(self)

    def build(self):
        t0 = time.time()
        blobs = real_build(self)
        builds.append((time.time() - t0) * 1e3)
        return blobs

    ts.train_step = step
    loader_lib.RoIDataLoader._loader_thread = loader_thread
    loader_lib.RoIDataLoader.build_minibatch = build
    try:
        model = initialize_model_from_cfg()
        solver = train_engine.create_solver(model)
        torch.cuda.synchronize()
        t0 = time.time()
        records = train_engine.train_loop(model, solver, roidb, 0, steps)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        ts.train_step = real_step
        loader_lib.RoIDataLoader._loader_thread = real_thread
        loader_lib.RoIDataLoader.build_minibatch = real_build
        # a thread's set_num_threads(1) is also the count that threads
        # started later take: give it back
        torch.set_num_threads(default_threads)
    cap = cfg.DATA_LOADER.MINIBATCH_QUEUE_SIZE
    for r, s in zip(records, per_step):
        r.update(s)
        r['iteration_s'] = r['data_s'] + r['upload_s'] + r['step_s']
    del model, solver
    torch.cuda.empty_cache()
    return records, builds, wall, cap


def summarize(rows):
    if not rows:
        return None
    out = {}
    for key, scale in (('iteration_s', 1e3), ('step_s', 1e3),
                       ('data_s', 1e3), ('upload_s', 1e3), ('cores', 1),
                       ('main_cpu', 1)):
        vals = [r[key] * scale for r in rows]
        out[key if scale == 1 else key[:-2] + '_ms'] = {
            'median': statistics.median(vals), 'min': min(vals),
            'max': max(vals)}
    out['steps'] = len(rows)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--steps', type=int, default=96)
    parser.add_argument('--rounds', type=int, default=2)
    args = parser.parse_args()
    smi = chip_smoke.phase_device()
    from nafwebsod_torch.ops import _build
    _build.build(['roi_pool'])
    _build.load('roi_pool')
    default_threads = torch.get_num_threads()
    print('torch intra-op threads on the main thread:', default_threads,
          '| os.cpu_count():', os.cpu_count(), flush=True)
    order = list(VARIANTS)
    runs = {name: [] for name in order}
    with tempfile.TemporaryDirectory() as root:
        reset_cfg()
        merge_cfg_from_cfg(FLAGSHIP)
        pixels, train_props = chip_smoke.write_flickr_dataset(
            root, cfg.PIXEL_MEANS)
        configure(train_props)
        roidb = combined_roidb_for_training(cfg.TRAIN.DATASETS,
                                            cfg.TRAIN.PROPOSAL_FILES)
        for entry in roidb:
            entry['image'] = pixels[entry['id']]
        # one untimed run: kernels, cuDNN plans and allocator warm
        configure(train_props)
        run_variant('A', roidb, 4, default_threads)
        for rnd in range(args.rounds):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                configure(train_props)
                records, builds, wall, cap = run_variant(
                    name, roidb, args.steps, default_threads)
                runs[name].append((records, builds))
                print('variant %s round %d (%d threads%s): %.2f s wall; '
                      'iteration ms %s; step ms %s; cores in the step %s; '
                      'the main thread\'s share of a core %s; queue %s; '
                      'build ms in the thread median %.1f (%d built)' % (
                          name, rnd, VARIANTS[name][0],
                          ', intra-op 1' if VARIANTS[name][1] else '', wall,
                          ['%.1f' % (r['iteration_s'] * 1e3)
                           for r in records],
                          ['%.1f' % (r['step_s'] * 1e3) for r in records],
                          ['%.2f' % r['cores'] for r in records],
                          ['%.2f' % r['main_cpu'] for r in records],
                          [r['queue_size'] for r in records],
                          statistics.median(builds), len(builds)),
                      flush=True)
    summary = {}
    for name in order:
        rows = [r for records, _ in runs[name] for r in records[1:]]
        late = [r for records, _ in runs[name]
                for r in records[len(records) // 2:]]
        summary[name] = {
            'loader_threads': VARIANTS[name][0],
            'intra_op_in_loader': 1 if VARIANTS[name][1] else
            default_threads,
            'filling': summarize([r for r in rows
                                  if r['queue_size'] < cap]),
            'full': summarize([r for r in rows if r['queue_size'] >= cap]),
            'second_half': summarize(late),
            'all': summarize(rows),
            'build_ms_in_thread': statistics.median(
                [b for _, builds in runs[name] for b in builds])}
    print('torch intra-op threads on the main thread after the runs:',
          torch.get_num_threads(), flush=True)
    print(json.dumps(summary))
    print(torch.__config__.parallel_info().strip().replace('\n', ' | '))
    print(smi)


if __name__ == '__main__':
    main()
