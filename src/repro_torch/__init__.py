"""PyTorch/CUDA port of the fiber-navigable filtered-ANN search.

The reference computes every search product in full float32, so the port
turns TF32 off for matmuls and convolutions: with TF32 a float32 product
on the card keeps about three decimal digits and the seed/score
comparisons would drift from the reference's. Its LM products are bf16
with fp32 sums, so the port also turns off cuBLAS's reduced-precision
(bf16) reductions inside bf16 matmuls.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
