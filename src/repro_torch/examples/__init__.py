"""The port's example drivers, counterparts of the root `examples/`:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.edge_iot_noniid [--rounds 8] [--device cpu]
    python -m repro_torch.examples.serve_decode [--device cpu]

Each runs on the CUDA card unless `--device` names another device.
"""
