"""Production mesh construction (the JAX package's `launch/mesh.py`), on
torch DeviceMesh.

`make_production_mesh` is a FUNCTION, so importing this module touches
no device and no process group. It needs a process group of 256 ranks
(one pod: a 16 x 16 ("data", "model") mesh) or 512 (two pods: 2 x 16 x 16
("pod", "data", "model")), one card a rank, initialised by the caller
(`torch.distributed.init_process_group` with the address, world size
and rank given explicitly), and raises otherwise.

The constants are one NVIDIA H100's (NVIDIA's data sheet, SXM part,
dense rates without sparsity; the card these runs use reads "NVIDIA
H100 80GB HBM3, 700.00 W" in `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`, and the rates assume that 700 W limit). No TPU
figure stays.
"""
from __future__ import annotations

POD_SHAPE = (16, 16)
POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) DeviceMesh over the default process
    group's ranks, one card a rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else POD_AXES
    want = 1
    for n in shape:
        want *= n
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != want:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a process "
            f"group of {want} ranks for the {shape} {axes} mesh; "
            + ("no process group is initialised" if have is None
               else f"the world size is {have}"))
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


# NVIDIA H100 80GB HBM3, 700.00 W (roofline targets per card)
PEAK_FLOPS_BF16 = 989e12        # bf16 dense tensor-core peak, FLOP/s
HBM_BW = 3.35e12                # HBM3 bandwidth, bytes/s
NVLINK_BW = 450e9               # NVLink 4, bytes/s each way (900 GB/s both)
# NVIDIA H100 80GB HBM3, 700.00 W: torch.cuda.get_device_properties(0)
# .total_memory
CHIP_HBM_BYTES = 85_017_493_504
