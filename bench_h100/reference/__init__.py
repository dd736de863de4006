"""The plain PyTorch reference that decides ``correct``: the models
(``models.py``), the sliding-window pipeline (``pipeline.py``), the training
steps (``train.py``) and the control's lower precision (``quant.py``). It
imports nothing of the program under test."""

import contextlib

import torch


@contextlib.contextmanager
def float32_exact():
    """float32 products without TF32 (cuBLAS and cuDNN), restored after."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
