"""dpmn_tpu_torch — the PyTorch + CUDA port of dpmn_tpu for one NVIDIA H100.

The JAX package `dpmn_tpu` is the reference this package is held against; the
port imports nothing of it (and nothing of JAX).  Plain tensor code is
PyTorch in NCHW; the TPU kernels of the eval forward and the train step are
CUDA C++ kernels for sm_90a under `csrc/`, built with nvcc at first use and
bound with ctypes (see `ops/kernels.py`): the eval window-attention block
(K1), the GRU scan (K2), and the three training window-attention cores with
their backward — LN + projections + attention (K3), attention on projected
q, k, v (K4), K3 with SKConv inside (K5) — and four standalone ops whose TPU
kernels no path calls: the faithful Mlp conv pair (K6), the eval attention
on projected q, k, v in float32 or bf16 (K7), per-window attention tiles
(K8) and the dump of the training cores' dropout masks (K9).  Each kernel
has a plain PyTorch version of the same function beside it, which the CPU
tests use and which runs for CPU tensors only: a CUDA tensor launches the
kernel or raises.

Numerics: the card computes float32 in full float32.  TF32 is switched off
for matmuls and for cuDNN (convolutions and RNNs), so that the card computes
what the CPU oracle computes, up to summation order.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU.  Without a card and without an explicit "cpu" this raises; it
    never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dpmn_tpu_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run the plain PyTorch path on the CPU'
        )
    return dev
