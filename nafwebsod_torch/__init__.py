"""PyTorch / CUDA port of the NA-fWebSOD framework.

A second package beside ``nafwebsod_tpu`` (the JAX reference). It imports
``torch`` and never ``jax`` or ``nafwebsod_tpu``; module names mirror the
JAX package so each counterpart is easy to find. The RoIPoolF forward is a
hand-written CUDA kernel for sm_90a (``ops/csrc/roi_pool.cu``); convs and
GEMMs go to cuDNN/cuBLAS through torch.

Entry points run on the card (``device='cuda'``) unless the caller passes
``device='cpu'``; with no GPU and no explicit CPU request they raise.
"""
