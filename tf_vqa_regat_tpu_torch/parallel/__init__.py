"""Data parallelism of the port (counterpart of tf_vqa_regat_tpu/parallel/):
one process per rank in a torch.distributed group, each rank on its own
device, its own rows of every batch, and one all-reduce of the gradients per
optimizer step (distributed.py, mesh.py)."""
