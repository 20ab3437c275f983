"""Per-iteration training statistics (port of the JAX package's
``utils/training_stats.py``): median-smoothed loss and metric windows of
1280 iterations (the JAX package's ``max(1280 // num_devices, 100)`` on
one card), iteration time with an ETA, the loader's queue depth, and
``json_stats:`` lines every ``LOG_PERIOD`` iterations and at the last
one. ``mem`` is the card's peak allocated memory in MiB
(``torch.cuda.max_memory_allocated``); on the CPU the key is absent, as
it is on the JAX package's CPU backend.
"""

import datetime

import torch

from nafwebsod_torch.core.config import cfg
from nafwebsod_torch.utils.logging_utils import SmoothedValue, log_json_stats
from nafwebsod_torch.utils.timer import Timer


class TrainingStats:
    # the JAX package's max(1280 // num_devices, 100) on one card
    WIN_SZ = 1280
    LOG_PERIOD = 20

    def __init__(self, device=None):
        self.device = torch.device(device or 'cpu')
        self.iter_timer = Timer()
        self.filter_losses_and_metrics = []
        self.smoothed_losses_and_metrics = {}
        self.smoothed_total_loss = SmoothedValue(self.WIN_SZ)
        self.iter_total_loss = float('nan')

    def IterTic(self):
        self.iter_timer.tic()

    def IterToc(self):
        return self.iter_timer.toc(average=False)

    def UpdateIterStats(self, total_loss, aux):
        """total_loss: float; aux: {name: scalar}."""
        for k, v in aux.items():
            if k not in self.smoothed_losses_and_metrics:
                self.smoothed_losses_and_metrics[k] = SmoothedValue(
                    self.WIN_SZ)
                self.filter_losses_and_metrics.append(k)
            self.smoothed_losses_and_metrics[k].AddValue(float(v))
        self.iter_total_loss = float(total_loss)
        self.smoothed_total_loss.AddValue(self.iter_total_loss)

    def LogIterStats(self, cur_iter, lr, queue_size=None):
        final = cur_iter == cfg.SOLVER.MAX_ITER - 1
        if final or cur_iter % self.LOG_PERIOD == 0:
            log_json_stats(self.GetStats(cur_iter, lr, queue_size))

    def GetStats(self, cur_iter, lr, queue_size=None):
        per_iter = self.iter_timer.average_time
        remaining = int(per_iter * (cfg.SOLVER.MAX_ITER - cur_iter))
        stats = {
            'iter': cur_iter,
            'lr': float(lr),
            'time': per_iter,
            'loss': self.smoothed_total_loss.GetMedianValue(),
            'eta': str(datetime.timedelta(seconds=remaining)),
        }
        if queue_size is not None:
            stats['queue_size'] = queue_size
        for k in self.filter_losses_and_metrics:
            stats[k] = self.smoothed_losses_and_metrics[k].GetMedianValue()
        if self.device.type == 'cuda':
            stats['mem'] = int(
                torch.cuda.max_memory_allocated(self.device) / 2 ** 20)
        return stats
