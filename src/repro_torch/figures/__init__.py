"""The paper's figure drivers on the port, counterparts of the JAX
package's `benchmarks/` drivers of the same names:

    python -m repro_torch.figures.fig3_accuracy [--full] [--jobs N]
    python -m repro_torch.figures.fig1_metric [--full]
    python -m repro_torch.figures.comm_efficiency [--quick] [--json]
    python -m repro_torch.figures.population_bench [--quick] [--json]

Each keeps the reference's record schema and writes it under a port name
(`artifacts/bench/<driver>__torch.json`; `--json` files land in
`artifacts/` as `BENCH_*__torch.json`, beside, never over, the root
`BENCH_*.json`). Each runs on the CUDA card unless `--device` names
another device.
"""
