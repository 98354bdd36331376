"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions — the port of the Pallas TPU kernels in `repro.kernels`.

Each kernel keeps the trio layout of the JAX package: the CUDA source in
`repro_torch/csrc/`, an `ops.py` wrapper (argument checks, layout,
device dispatch, launch count) and a plain `ref.py`:

  quant_pack  stochastic int8/int4 quantize-and-pack, the fused
              quantize + pack + error-feedback pass, and the decode
  wire_agg    fused dequant + masked aggregate (Eq.-7 mean, median,
              trimmed mean) of C packed payloads
  flash_attention
              online-softmax attention (causal, sliding window, query
              offset, valid kv length, GQA), the serve path's prefill
  rglru_scan  the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t, and
              its backward (the reverse walk)
  worker_conv the 3x3 stride-1 "SAME" convolution of C workers at once
              (forward, input and weight gradients), which the CNN
              models' vmapped convolutions reach on the card

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises (`runtime`). Kernels build with nvcc on first use.
"""
