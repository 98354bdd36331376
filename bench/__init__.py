"""The benchmark of the PyTorch/CUDA port (`repro_torch`): one cell a
process, driven by the files under configs/, workloads/ and metrics/.
See README.md."""
