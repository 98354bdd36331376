"""The plain references that decide `correct`: plain PyTorch written from
the paper and the published configurations. Nothing here imports JAX,
the JAX package or the port; the inputs come from bench/generator.py, the
same that the port is handed."""
