"""Device resolution and the float32 precision contract.

Entry points run on the card unless the caller passes ``device="cpu"``
(the tests do).  With no CUDA device and no explicit CPU request they
raise: nothing drops silently to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> the current card (raises RuntimeError when there is no
    card); an explicit device passes through, after the same check for
    CUDA.  A bare "cuda" gets the current card's index, so under one
    process per rank it names the card ``torch.cuda.set_device`` chose
    (``parallel.multihost.initialize``), and compares equal to the
    devices of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    set_full_fp32()
    return dev


def set_full_fp32() -> None:
    """Turn TF32 off for matmuls AND cuDNN convolutions, and keep the
    reductions of bf16/fp16 GEMMs in float32.

    TF32 keeps ~3 decimal digits: catastrophic in log space at quiet mel
    bins (the JAX frontend runs its DFT at Precision.HIGHEST for the same
    reason), and it would break every float32 parity run.  cuDNN's
    default allow_tf32=True covers the conv stem.  PyTorch lets cuBLAS
    reduce split-K bf16/fp16 GEMMs in the reduced type by default; the
    JAX ``linear`` and attention accumulate in float32
    (preferred_element_type), so that is turned off too.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
