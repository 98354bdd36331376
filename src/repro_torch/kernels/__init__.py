"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions — the port of the Pallas TPU kernels in `repro.kernels`.

Each kernel keeps the trio layout of the JAX package: the CUDA source in
`repro_torch/csrc/`, an `ops.py` wrapper (argument checks, layout,
device dispatch, launch count) and a plain `ref.py`:

  quant_pack  stochastic int8/int4 quantize-and-pack, the fused
              quantize + pack + error-feedback pass, and the decode
  wire_agg    fused dequant + masked aggregate (Eq.-7 mean, median,
              trimmed mean) of C packed payloads

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises (`runtime`). Kernels build with nvcc on first use.
"""
