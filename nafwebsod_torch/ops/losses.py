"""Losses of the WSL / webly stack (port of the JAX package's
``ops/losses.py``, the cross-entropy pair and the logged accuracy).

``cross_entropy_with_logits`` and ``weighted_cross_entropy_with_logits``
operate on *probabilities* despite their names (the reference's
``cross_entropy_wsl_op.cc``): binary CE summed over all elements, divided
by C when ``is_mean`` and always by N; probabilities are clamped at 1e-20
before the log; the analytic gradient is clamped at +1e4 *before* the
per-element weight and the 1/N scale. That clamp is why both go through a
``torch.autograd.Function``: autograd of the forward alone gives another
gradient.

Not ported yet: ``min_entropy_loss``, ``softmax_with_loss_n`` and the
supervised losses (they belong to other model families).
"""

import torch

KLOG_THRESHOLD = 1e-20
KDIFF_THRESHOLD = 1e4


class _CrossEntropy(torch.autograd.Function):
    """CE on probabilities with the reference's clamped gradient;
    ``weights`` may be None."""

    @staticmethod
    def forward(ctx, probs, labels, weights, is_mean):
        ctx.save_for_backward(probs, labels)
        ctx.weights = weights
        ctx.is_mean = is_mean
        n, c = probs.shape
        norm = float(c) if is_mean else 1.0
        p = probs.clamp(min=KLOG_THRESHOLD)
        one_p = (1.0 - probs).clamp(min=KLOG_THRESHOLD)
        elem = -(labels * torch.log(p) + (1.0 - labels) * torch.log(one_p))
        if weights is not None:
            elem = elem * weights
        return elem.sum() / norm / n

    @staticmethod
    def backward(ctx, g):
        probs, labels = ctx.saved_tensors
        n, c = probs.shape
        norm = float(c) if ctx.is_mean else 1.0
        p = probs.clamp(min=KLOG_THRESHOLD)
        one_p = (1.0 - probs).clamp(min=KLOG_THRESHOLD)
        grad = g * (-labels / p + (1.0 - labels) / one_p) / norm
        grad = grad.clamp(max=KDIFF_THRESHOLD)
        if ctx.weights is not None:
            grad = grad * ctx.weights
        return grad / n, None, None, None


def cross_entropy_with_logits(probs, labels, is_mean=False):
    """probs, labels: (N, C). Gradient to ``probs`` only."""
    return _CrossEntropy.apply(probs, labels, None, is_mean)


def weighted_cross_entropy_with_logits(probs, labels, weights,
                                       is_mean=False):
    """As above with a per-element weight (N, C) or (1, C), a constant."""
    return _CrossEntropy.apply(probs, labels, weights.detach(), is_mean)


def multilabel_accuracy(cls_prob, labels_oh):
    """Whether the argmax class of the image-level score (1, C) is one of
    the image's classes (the reference logs Caffe2 ``Accuracy``)."""
    return labels_oh[0, torch.argmax(cls_prob[0])]
