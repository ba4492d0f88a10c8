"""The plain reference the benchmark holds the port's outputs against:
float32 PyTorch with TF32 off, written from the papers and the original
code, importing nothing of the port."""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
