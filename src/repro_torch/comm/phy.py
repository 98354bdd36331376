"""The per-worker physical layer under the uplink.

  PhyState    per-worker complex fading gain, static pathloss, the
              instantaneous received SNR, and the rounds since the
              worker's last delivered upload
  evolve      Rayleigh block fading as a Gauss-Markov process
              h' = rho h + sqrt(1 - rho^2) CN(0, 1), from unit gain
              (`lazy_fading_coeffs`: Δ rounds of it in closed form)
  LinkModel   the channel enum decomposed into delivery (packet erasure,
              SNR outage) x distortion (AWGN)

Random draws are inputs: `evolve` takes the (2, C) standard normals of
the innovation, `delivery_mask` the (C,) bernoulli keep draw.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.comm.budget import CommConfig

_GAIN_FLOOR = 1e-12   # |h|^2 floor before the dB conversion (deep fade)


class PhyState(NamedTuple):
    h_re: torch.Tensor          # (C,) fading gain, real part
    h_im: torch.Tensor          # (C,) fading gain, imag part
    pathloss_db: torch.Tensor   # (C,) static pathloss (>= 0 dB)
    snr_db: torch.Tensor        # (C,) instantaneous received SNR
    age: torch.Tensor           # (C,) int32 rounds since last delivery


def pathloss_profile(cfg: CommConfig, num_workers: int,
                     device=None) -> torch.Tensor:
    """Workers spread evenly over [0, pathloss_spread_db] dB."""
    if num_workers == 1:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    return torch.linspace(0.0, cfg.pathloss_spread_db, num_workers,
                          dtype=torch.float32, device=device)


def instantaneous_snr_db(cfg: CommConfig, h_re: torch.Tensor,
                         h_im: torch.Tensor,
                         pathloss_db: torch.Tensor) -> torch.Tensor:
    gain2 = torch.clamp(h_re * h_re + h_im * h_im, min=_GAIN_FLOOR)
    return (cfg.snr_db - pathloss_db
            + 10.0 * torch.log10(gain2)).to(torch.float32)


def init_state(cfg: CommConfig, num_workers: int, device=None) -> PhyState:
    """Unit-gain start, so E|h_t|^2 = 1 from the first round."""
    ones = torch.ones((num_workers,), dtype=torch.float32, device=device)
    zeros = torch.zeros((num_workers,), dtype=torch.float32, device=device)
    pl = pathloss_profile(cfg, num_workers, device)
    return PhyState(h_re=ones, h_im=zeros, pathloss_db=pl,
                    snr_db=instantaneous_snr_db(cfg, ones, zeros, pl),
                    age=torch.zeros((num_workers,), dtype=torch.int32,
                                    device=device))


def evolve(cfg: CommConfig, phy: PhyState,
           normals: Optional[torch.Tensor]) -> PhyState:
    """One round of block fading; `normals` (2, C) standard normal draws
    (real, imaginary). fading="none" is the identity."""
    if cfg.fading == "none":
        return phy
    rho = cfg.doppler_rho
    dev = phy.h_re.device
    innov = torch.sqrt(torch.tensor(max(1.0 - rho * rho, 0.0),
                                    dtype=torch.float32, device=dev))
    std = torch.sqrt(torch.tensor(0.5, dtype=torch.float32, device=dev))
    h_re = rho * phy.h_re + innov * std * normals[0]
    h_im = rho * phy.h_im + innov * std * normals[1]
    return phy._replace(
        h_re=h_re, h_im=h_im,
        snr_db=instantaneous_snr_db(cfg, h_re, h_im, phy.pathloss_db))


def lazy_fading_coeffs(cfg: CommConfig, steps: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Δ rounds of Gauss-Markov fading in one draw: iterating h' = rho h
    + sqrt(1 - rho^2) CN(0, 1) Δ times gives h = rho^Δ h + sqrt(1 -
    rho^(2Δ)) CN(0, 1). Returns (rho^Δ, the innovation scale) for an
    int `steps` vector; Δ = 0 gives (1, 0)."""
    rho_d = torch.pow(torch.tensor(cfg.doppler_rho, dtype=torch.float32,
                                   device=steps.device),
                      steps.to(torch.float32))
    return rho_d, torch.sqrt(torch.clamp(1.0 - rho_d * rho_d, min=0.0))


def advance_age(phy: PhyState, mask_eff: torch.Tensor,
                buffered: Optional[torch.Tensor] = None) -> PhyState:
    """A delivered upload resets the worker's age; everyone else ages.
    `buffered` (the straggler engine's buffer ages) marks late uploads
    parked at the PS: their age pins at 1. buffered=None leaves the
    delivered/undelivered rule as it is."""
    delivered = mask_eff > 0
    aged = torch.where(delivered, torch.zeros_like(phy.age), phy.age + 1)
    if buffered is not None:
        aged = torch.where((buffered > 0) & ~delivered,
                           torch.ones_like(aged), aged)
    return phy._replace(age=aged)


class LinkModel(NamedTuple):
    drop_prob: float               # delivery: P(packet lost)
    awgn: bool                     # distortion: AWGN at the received SNR
    outage_db: Optional[float]     # delivery: SNR outage threshold
    per_worker: bool               # SNRs differ per worker


def link_model(cfg: CommConfig) -> LinkModel:
    return LinkModel(
        drop_prob=(cfg.drop_prob if cfg.channel in ("erasure", "composite")
                   else 0.0),
        awgn=cfg.channel in ("awgn", "composite"),
        outage_db=cfg.outage_snr_db,
        per_worker=(cfg.fading != "none" or cfg.pathloss_spread_db > 0.0),
    )


def delivery_mask(cfg: CommConfig, mask: torch.Tensor,
                  keep: Optional[torch.Tensor],
                  snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Which selected uploads arrive: packet erasure (the injected (C,)
    keep draw, 1 = kept) composed with SNR outage."""
    link = link_model(cfg)
    out = mask
    if link.drop_prob > 0.0:
        out = out * keep.to(mask.dtype)
    if link.outage_db is not None and snr_db is not None:
        out = out * (snr_db >= link.outage_db).to(mask.dtype)
    return out


def noise_sigma_superposed(cfg: CommConfig, s: torch.Tensor) -> torch.Tensor:
    """Analog-aggregation sigma at the shared snr_db, relative to the
    superposed RMS power."""
    sig_rms = torch.sqrt(torch.mean(s * s))
    return sig_rms * (10.0 ** (-cfg.snr_db / 20.0))


def noise_sigma_per_worker(d: torch.Tensor,
                           snr_db: torch.Tensor) -> torch.Tensor:
    """Per-upload decode sigma at each worker's own SNR, broadcastable
    against d (leading worker dim)."""
    C = d.shape[0]
    axes = tuple(range(1, d.ndim))
    rms = torch.sqrt(torch.mean(d * d, dim=axes) + 1e-20)
    sigma = rms * (10.0 ** (-snr_db / 20.0))
    return sigma.reshape((C,) + (1,) * (d.ndim - 1))
