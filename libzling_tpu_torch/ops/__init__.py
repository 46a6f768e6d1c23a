"""Kernels (K3 decode_fused, K4 tokenize_kernel, K5 relabel_kernel) and the
torch stages around them; module names mirror ``libzling_tpu/ops``."""
