from repro_torch.kernels.rglru_scan.ops import (rglru_scan,
                                                rglru_scan_bwd_raw,
                                                rglru_scan_raw)
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)

__all__ = ["rglru_scan", "rglru_scan_bwd_raw", "rglru_scan_bwd_ref",
           "rglru_scan_raw", "rglru_scan_ref"]
