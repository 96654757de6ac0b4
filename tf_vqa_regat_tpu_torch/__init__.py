"""PyTorch port of tf_vqa_regat_tpu for NVIDIA Hopper GPUs.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package becomes
a CUDA kernel written for sm_90a (csrc/), built from source at first use.
Imports torch, never JAX. Entry point: `python -m tf_vqa_regat_tpu_torch.main`.
"""
