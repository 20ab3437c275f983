"""Device resolution for the port's entry points."""

import torch


def resolve_device(device=None):
    """The device an entry point runs on.

    ``None`` means the card: it raises when CUDA is unavailable instead of
    carrying on on the CPU, so a run that was meant for the GPU can never
    silently measure or validate the CPU path. Pass ``'cpu'`` explicitly
    for the plain-PyTorch path (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run the '
                'plain PyTorch path on the CPU')
        return torch.device('cuda')
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device {} requested but CUDA is unavailable'
                           .format(device))
    return device
