"""Loss kernels of the weakly supervised segmentation branch (port of the
two functions of the JAX package's ``ops/misc.py`` that the deeplab head
calls).
"""

import torch
import torch.nn.functional as F


def kl_balanced(p, q, ignore_value=0.5):
    """The reference KL op's kernel: per outer index

        out_i = -sum_{q != ignore} q * log(1/q * sigmoid(p)) / denom

    with ``denom`` the count of non-ignored targets on that element's side
    of 0.5 (positive / negative balancing) and ``p`` consumed as a sigmoid
    LOGIT (the deeplab call site passes sigmoid probabilities in that slot,
    and so does the port). ``q`` is clamped at the CRF's 1e-4 output floor
    so q * log(q) stays finite. p, q: (B, ...). Returns (B,)."""
    b = p.shape[0]
    pf = p.reshape(b, -1)
    q_raw = q.reshape(b, -1)
    qf = q_raw.clamp(min=1e-4)
    keep = q_raw != ignore_value
    pos_side = qf > 0.5
    pos = (keep & pos_side).sum(dim=1).to(pf.dtype)
    neg = (keep & ~pos_side).sum(dim=1).to(pf.dtype)
    denom = torch.where(pos_side, pos[:, None], neg[:, None])
    # q * log(1 / q / (1 + exp(-p))) == -q * (log q + softplus(-p))
    term = -qf * (torch.log(qf) + F.softplus(-pf))
    term = torch.where(keep & (denom > 0), term / denom.clamp(min=1.0),
                       torch.zeros_like(term))
    return -term.sum(dim=1)


def sigmoid_cross_entropy_with_logits_wsl(logits, targets, ignore_value=0.5):
    """Elementwise sigmoid CE that ignores targets equal to
    ``ignore_value``, averaged over the non-ignored pixels of each (image,
    class). logits, targets: (B, C, H, W). Returns (xent (B, C), counts
    (B, C, 2) of positive and negative pixels)."""
    not_ignored = targets != ignore_value
    x = logits
    # numerically stable: max(x, 0) - x * t + log(1 + exp(-|x|))
    elem = x.clamp(min=0) - x * targets + torch.log1p(torch.exp(-x.abs()))
    elem = torch.where(not_ignored, elem, torch.zeros_like(elem))
    pos = ((targets > 0.5) & not_ignored).sum(dim=(2, 3))
    neg = ((targets <= 0.5) & not_ignored).sum(dim=(2, 3))
    denom = (pos + neg).clamp(min=1).to(logits.dtype)
    xent = elem.sum(dim=(2, 3)) / denom
    counts = torch.stack([pos, neg], dim=2).to(logits.dtype)
    return xent, counts
