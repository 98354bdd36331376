"""Byte-accurate communication accounting (paper §IV-C, made literal):
`CommConfig`, the wire configuration (same fields, defaults and
validation as the JAX package's), and the per-round `CommRecord` of
bytes on the wire, SNR->rate airtime and transmit energy.

Conventions: uplink payloads are counted per transmitting worker (a lost
packet still used its airtime); the downlink broadcast to all C workers
is charged at the downlink compressor's payload; dense payloads at each
leaf's dtype width; quantized payloads carry one f32 scale per
(256, 128) kernel block; top-k payloads carry value + int32 index pairs.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.pytree import tree_leaves

PyTree = Any

FLOAT_BYTES = 4   # fp32 model / value payloads
INDEX_BYTES = 4   # int32 coordinate payloads (top-k)
SCALE_BYTES = 4   # one fp32 scale per quantization block

# Elements covered by one quantization-block scale. Must match
# kernels/quant_pack (BLOCK_ROWS * 128 lanes).
QUANT_BLOCK_ELEMS = 256 * 128

COMPRESSORS = ("identity", "topk", "int8", "int4")
# "composite" = packet erasure AND AWGN in one round — the delivery and
# distortion axes of comm.phy.LinkModel applied together (the legacy
# enum could only express one at a time)
CHANNELS = ("ideal", "erasure", "awgn", "composite")
BYZANTINE_MODES = ("sign_flip", "gaussian")
AGGREGATORS = ("mean", "median", "trimmed_mean")
FADING_MODELS = ("none", "rayleigh")
RATE_MODELS = ("shannon",)
TIER_RANKS = ("score", "snr")


class CommConfig(NamedTuple):
    """Static (hashable) wire configuration, carried on the engine
    configs and closed over by the jitted round functions."""
    compressor: str = "identity"        # see COMPRESSORS
    topk_ratio: float = 0.05            # fraction of entries kept per leaf
    error_feedback: bool = True         # carry compression error residuals
    channel: str = "ideal"              # see CHANNELS
    drop_prob: float = 0.1              # erasure: P(upload lost)
    snr_db: float = 20.0                # awgn: analog-aggregation SNR
    byzantine: int = 0                  # adversarial workers (last k of C)
    byzantine_mode: str = "sign_flip"   # see BYZANTINE_MODES
    byzantine_scale: float = 1.0        # gaussian attack std
    aggregator: str = "mean"            # see AGGREGATORS (Eq. 7 variants)
    trim_ratio: float = 0.1             # trimmed_mean: fraction cut per side
    downlink_compressor: str = "identity"  # PS broadcast compression
    adaptive_bits: bool = False         # per-worker wire tiers (rank-based)
    # -- physical layer (comm.phy) --------------------------------------
    fading: str = "none"                # see FADING_MODELS
    doppler_rho: float = 0.95           # Gauss-Markov round correlation
    pathloss_spread_db: float = 0.0     # static per-worker pathloss spread
    outage_snr_db: Optional[float] = None  # delivery: SNR outage cut (None off)
    rate_model: str = "shannon"         # see RATE_MODELS (SNR -> rate)
    bandwidth_hz: Optional[float] = 1e6  # uplink bandwidth per worker
    #                                      (None = no rate model: airtime/
    #                                      energy unpriced, deadlines off)
    tx_power_w: float = 0.1             # transmit power (energy accounting)
    coding_gap_db: float = 3.0          # practical-coding gap to capacity
    # -- adaptive tiers (widened: N tiers, score- or SNR-ranked) --------
    num_tiers: int = 2                  # adaptive_bits: wire tier count
    tier_rank: str = "score"            # see TIER_RANKS (Eq.-5 | inst. SNR)
    # -- straggler / deadline engine (comm.straggler) -------------------
    round_deadline_s: Optional[float] = None  # uplink airtime budget per
    #                                    round; an upload whose airtime
    #                                    exceeds it is late -> buffered
    #                                    (None = every upload on time)
    staleness_gamma: float = 1.0        # drain discount 1/(1+age)^gamma
    quorum: int = 0                     # min deltas (fresh + drained) to
    #                                    apply an aggregate (0 = no gate)
    # -- fault injection (deterministic worker churn) -------------------
    fault_prob: float = 0.0             # P(worker starts an outage /round)
    fault_rounds: int = 1               # outage length in rounds
    fault_seed: int = 0                 # schedule stream (static, keyed
    #                                    off the round index like POP_SALT)

    def validate(self) -> "CommConfig":
        if self.compressor not in COMPRESSORS:
            raise ValueError(f"unknown compressor {self.compressor!r}")
        if self.downlink_compressor not in COMPRESSORS:
            raise ValueError(f"unknown downlink compressor "
                             f"{self.downlink_compressor!r}")
        if self.channel not in CHANNELS:
            raise ValueError(f"unknown channel {self.channel!r}")
        if self.aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {self.aggregator!r}")
        if self.byzantine_mode not in BYZANTINE_MODES:
            raise ValueError(f"unknown byzantine mode "
                             f"{self.byzantine_mode!r}")
        if not 0.0 < self.topk_ratio <= 1.0:
            raise ValueError(f"topk_ratio must be in (0, 1], got "
                             f"{self.topk_ratio}")
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError(f"drop_prob must be in [0, 1), got "
                             f"{self.drop_prob}")
        if not 0.0 <= self.trim_ratio < 0.5:
            raise ValueError(f"trim_ratio must be in [0, 0.5), got "
                             f"{self.trim_ratio}")
        if self.fading not in FADING_MODELS:
            raise ValueError(f"unknown fading model {self.fading!r}")
        if self.rate_model not in RATE_MODELS:
            raise ValueError(f"unknown rate model {self.rate_model!r}")
        if self.tier_rank not in TIER_RANKS:
            raise ValueError(f"unknown tier rank {self.tier_rank!r}")
        if not 0.0 <= self.doppler_rho <= 1.0:
            raise ValueError(f"doppler_rho must be in [0, 1], got "
                             f"{self.doppler_rho}")
        if self.pathloss_spread_db < 0.0:
            raise ValueError(f"pathloss_spread_db must be >= 0, got "
                             f"{self.pathloss_spread_db}")
        if self.bandwidth_hz is not None and self.bandwidth_hz <= 0.0:
            raise ValueError(f"bandwidth_hz must be > 0 (or None to "
                             f"disable the rate model), got "
                             f"{self.bandwidth_hz}")
        if self.tx_power_w <= 0.0:
            raise ValueError(f"tx_power_w must be > 0, got "
                             f"{self.tx_power_w}")
        if self.coding_gap_db < 0.0:
            raise ValueError(f"coding_gap_db must be >= 0, got "
                             f"{self.coding_gap_db}")
        if self.num_tiers < 2:
            raise ValueError(f"num_tiers must be >= 2, got {self.num_tiers}")
        if (self.tier_rank == "snr" and self.fading == "none"
                and self.pathloss_spread_db == 0.0):
            raise ValueError(
                "tier_rank='snr' needs per-worker SNRs: enable "
                "fading='rayleigh' or a pathloss_spread_db > 0 — with a "
                "uniform SNR the ranking is arbitrary")
        if (self.outage_snr_db is not None and self.fading == "none"
                and self.pathloss_spread_db == 0.0):
            raise ValueError(
                "outage_snr_db needs per-worker SNR dynamics "
                "(fading='rayleigh' or pathloss_spread_db > 0) — with "
                "one static fleet-wide SNR the outage is a degenerate "
                "all-or-nothing blackout")
        if self.round_deadline_s is not None and self.round_deadline_s <= 0.0:
            raise ValueError(f"round_deadline_s must be > 0 (or None to "
                             f"disable deadlines), got "
                             f"{self.round_deadline_s}")
        if self.round_deadline_s is not None and self.bandwidth_hz is None:
            # mirrors the outage-needs-per-worker-SNR cross-check: a
            # deadline is only meaningful against an airtime, and airtime
            # needs the SNR -> rate model
            raise ValueError(
                "round_deadline_s needs a rate model to derive airtimes "
                "(payload_bytes / rate_bps) — set bandwidth_hz")
        if self.staleness_gamma < 0.0:
            raise ValueError(f"staleness_gamma must be >= 0, got "
                             f"{self.staleness_gamma}")
        if self.quorum < 0:
            raise ValueError(f"quorum must be >= 0, got {self.quorum}")
        if self.quorum > 0 and self.round_deadline_s is None:
            raise ValueError(
                "quorum gating rides the straggler engine — set "
                "round_deadline_s to enable it")
        if not 0.0 <= self.fault_prob < 1.0:
            raise ValueError(f"fault_prob must be in [0, 1), got "
                             f"{self.fault_prob}")
        if self.fault_rounds < 1:
            raise ValueError(f"fault_rounds must be >= 1, got "
                             f"{self.fault_rounds}")
        return self



class CommRecord(NamedTuple):
    """One round of wire accounting (f32 scalar tensors)."""
    bytes_up: torch.Tensor            # transmitted: selected x payload
    bytes_down: torch.Tensor          # broadcast: C x downlink payload
    delivered: torch.Tensor           # uploads surviving the channel
    compression_ratio: torch.Tensor   # dense payload / mean uplink payload
    airtime_s: torch.Tensor           # uplink airtime
    energy_j: torch.Tensor            # transmit energy = tx_power * airtime
    mean_snr_db: torch.Tensor         # fleet-mean received SNR


def topk_count(n: int, ratio: float) -> int:
    """Entries kept by top-k on an n-element leaf (>= 1)."""
    return max(1, int(n * ratio))


def _quant_blocks(n: int) -> int:
    return -(-n // QUANT_BLOCK_ELEMS)


def leaf_payload_bytes(cfg: CommConfig, n: int,
                       itemsize: int = FLOAT_BYTES) -> int:
    """Exact uplink bytes for one n-element leaf of `itemsize`-byte
    dtype."""
    if cfg.compressor == "identity":
        return n * itemsize
    if cfg.compressor == "topk":
        return topk_count(n, cfg.topk_ratio) * (itemsize + INDEX_BYTES)
    if cfg.compressor == "int8":
        return n + _quant_blocks(n) * SCALE_BYTES
    if cfg.compressor == "int4":
        return -(-n // 2) + _quant_blocks(n) * SCALE_BYTES
    raise ValueError(cfg.compressor)


def payload_bytes(cfg: CommConfig, params: PyTree) -> int:
    """Per-worker uplink payload for a whole (unstacked) model."""
    return sum(leaf_payload_bytes(cfg, x.numel(), x.element_size())
               for x in tree_leaves(params))


def dense_bytes(params: PyTree) -> int:
    """Uncompressed payload at each leaf's dtype width."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def downlink_config(cfg: CommConfig) -> CommConfig:
    """The PS broadcast wire config: the downlink compressor with PS
    error feedback always on."""
    return cfg._replace(compressor=cfg.downlink_compressor,
                        error_feedback=True)


def degrade(cfg: CommConfig) -> CommConfig:
    """One wire tier down: identity -> int8 -> int4; top-k halves its
    keep ratio. int4 is the floor."""
    if cfg.compressor == "identity":
        return cfg._replace(compressor="int8")
    if cfg.compressor == "int8":
        return cfg._replace(compressor="int4")
    if cfg.compressor == "topk":
        return cfg._replace(topk_ratio=cfg.topk_ratio / 2.0)
    return cfg


def uplink_tiers(cfg: CommConfig) -> tuple[CommConfig, ...]:
    """The adaptive-bits degradation chain of up to `num_tiers` configs
    (tier 0 = the base config); a single tier without adaptive_bits."""
    if not cfg.adaptive_bits:
        return (cfg,)
    tiers = [cfg]
    while len(tiers) < cfg.num_tiers:
        nxt = degrade(tiers[-1])
        if nxt == tiers[-1]:
            break
        tiers.append(nxt)
    return tuple(tiers)


def rate_bps(cfg: CommConfig, snr_db: torch.Tensor) -> torch.Tensor:
    """Shannon rate backed off by the coding gap:
    R = B log2(1 + 10^((snr_db - gap_db) / 10))."""
    if cfg.bandwidth_hz is None:
        raise ValueError("rate_bps: no rate model (bandwidth_hz is None)")
    eff_snr = 10.0 ** ((snr_db - cfg.coding_gap_db) / 10.0)
    return cfg.bandwidth_hz * torch.log2(1.0 + eff_snr)


def worker_payload_bytes(cfg: CommConfig, params: PyTree, num_workers: int,
                         tier_idx: Optional[torch.Tensor] = None,
                         device=None) -> torch.Tensor:
    """(C,) f32 uplink payload bytes per worker, resolving tiers."""
    tiers = uplink_tiers(cfg)
    payloads = [payload_bytes(t, params) for t in tiers]
    if tier_idx is None or len(tiers) == 1:
        return torch.full((num_workers,), float(payloads[0]),
                          dtype=torch.float32, device=device)
    return sum((tier_idx == t).to(torch.float32) * p
               for t, p in enumerate(payloads))


def worker_airtime_s(cfg: CommConfig, worker_bytes: torch.Tensor,
                     snr_db: torch.Tensor) -> torch.Tensor:
    """(C,) per-upload airtime: bits over the rate at each worker's SNR."""
    return 8.0 * worker_bytes / rate_bps(cfg, snr_db)


def host_round_bytes(cfg: CommConfig, *, selected, bytes_up_jit,
                     payload_up: int, payload_down: int,
                     num_workers: int) -> tuple[float, int]:
    """Exact host-side (bytes_up, bytes_down) for one round's record:
    selected transmitters x the int payload, except under adaptive
    tiers, where the in-round accounting is the per-assignment truth."""
    up = (float(bytes_up_jit) if cfg.adaptive_bits
          else int(selected) * payload_up)
    return up, num_workers * payload_down


def round_record(cfg: CommConfig, params: PyTree, num_workers: int,
                 mask: torch.Tensor, mask_eff: torch.Tensor,
                 tier_idx: Optional[torch.Tensor] = None,
                 snr_db: Optional[torch.Tensor] = None) -> CommRecord:
    """Wire accounting for one round: `mask` the Eq.-6 selection,
    `mask_eff` the survivors, `tier_idx` the (C,) wire tier (None =
    one fleet-wide config), `snr_db` the (C,) received SNRs (None = the
    shared link budget)."""
    dev = mask.device
    tiers = uplink_tiers(cfg)
    dense = dense_bytes(params)
    payloads = [payload_bytes(t, params) for t in tiers]
    worker_bytes = worker_payload_bytes(cfg, params, num_workers,
                                        tier_idx=tier_idx, device=dev)
    if tier_idx is None or len(tiers) == 1:
        bytes_up = mask.sum() * payloads[0]
        mean_payload = torch.tensor(float(payloads[0]), device=dev)
    else:
        on_tier = [(tier_idx == t).to(torch.float32)
                   for t in range(len(tiers))]
        bytes_up = sum((mask * on_t).sum() * p
                       for on_t, p in zip(on_tier, payloads))
        mean_payload = sum(p * on_t.sum()
                           for on_t, p in zip(on_tier, payloads)
                           ) / num_workers
    bytes_down = num_workers * payload_bytes(downlink_config(cfg), params)
    snr = (snr_db if snr_db is not None
           else torch.full(mask.shape, cfg.snr_db, dtype=torch.float32,
                           device=dev))
    if cfg.bandwidth_hz is None:
        airtime = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        airtime = (mask * worker_airtime_s(cfg, worker_bytes, snr)).sum()
    f32 = torch.float32
    return CommRecord(
        bytes_up=bytes_up.to(f32),
        bytes_down=torch.tensor(float(bytes_down), dtype=f32, device=dev),
        delivered=mask_eff.sum(),
        compression_ratio=(dense / mean_payload).to(f32),
        airtime_s=airtime.to(f32),
        energy_j=(cfg.tx_power_w * airtime).to(f32),
        mean_snr_db=snr.mean().to(f32),
    )
