"""The benchmark of tf_vqa_regat_tpu_torch (ReGAT, PyTorch and CUDA on an
H100): `python3 -m regat_bench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
result line. Importing this package imports nothing."""
