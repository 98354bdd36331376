"""repro_torch — the M-DSL system ported to PyTorch, with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

The JAX package `repro` is the reference; this package mirrors its module
layout and names (`repro_torch.core.mdsl` <-> `repro.core.mdsl`, ...) and
imports neither `jax` nor `repro`. Entry points run on the CUDA card
unless the caller passes `device="cpu"`:

    from repro_torch.experiments import get_scenario, override, run
    run(override(get_scenario("low-bandwidth-int4"), "run.rounds=3"))

    python -m repro_torch.launch.train --scenario low-bandwidth-int4 \\
        --rounds 3 [--device cpu]

Random draws are explicit inputs of each round (`core.mdsl.RoundDraws`):
the port's own runs fill them from a `torch.Generator`; parity tests fill
them from the JAX key chain.
"""
