"""hitadv_torch — the HiT-ADV attack framework in PyTorch, with CUDA
kernels written by hand for NVIDIA Hopper (sm_90a).

A port of `hitadv_tpu` (JAX/Pallas on TPU), which stays the reference.
The same numpy parameter trees and the same inputs give the same
function in both packages (`hitadv_torch.convert.params_from_numpy`).

Conventions carried over from the reference:
  * clouds are ``[B, N, C]`` channels-last; linear and 1x1-conv weights
    are ``[Cin, Cout]``; BN is ``scale/bias/mean/var``;
  * the kernels of the hot path (`ops/csrc/*.cu`) are chosen by the
    tensor's device alone: a CUDA tensor launches the kernel (or raises),
    a CPU tensor runs the kernel's plain PyTorch version;
  * entry points (`make_hit_adv`, `make_cw_perturb`, `make_cw_knn`, the
    FGM makers, `make_saliency_drop`, `make_geoa3`, the model
    constructors, ``python -m hitadv_torch.{eval,train,visual,convert}``)
    run on ``device="cuda"`` unless the caller asks for the CPU.

The reference computes its distance and blend products in full f32, so
TF32 is switched off for matmuls and cuDNN here, where the package starts.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent.

    Entry points never carry on on the CPU by themselves: a caller that
    wants the CPU passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hitadv_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
