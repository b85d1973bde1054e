"""Arrival-process abstraction for the streaming simulator.

PyTorch port of `repro.core.arrivals`.  The paper's Section 4.2
characterizes query traffic as Poisson *within a stable window* whose
rate follows diurnal/weekly structure across windows.  An
:class:`ArrivalProcess` is a piecewise-constant rate function (qps per
time bin, tiling periodically) plus, optionally, a replayed trace of
concrete gaps.  Each simulator chunk reads the rate at its start time and
draws that chunk's exponential gaps at that rate.

Four constructors cover the load regimes:

  * :meth:`ArrivalProcess.stationary` — constant-rate Poisson (one bin);
  * :meth:`ArrivalProcess.piecewise` — explicit rate-per-bin profiles;
  * :meth:`ArrivalProcess.flash_crowd` — baseline rate + burst windows;
  * :meth:`ArrivalProcess.from_trace` — replay measured timestamps.

Leading dimensions of ``rates`` are scenario dimensions: a ``(S, B)``
rates tensor drives S independent scenarios through one profile shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._tensor import DEFAULT_DEVICE, DeviceLike, from_host

Tensor = torch.Tensor
TensorLike = Union[Tensor, np.ndarray, Sequence[float], float]

__all__ = ["ArrivalProcess"]


def _t(x, device, dtype) -> Tensor:
    return from_host(x, device, dtype).to(dtype)   # rates are never ints


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Piecewise-constant-rate Poisson arrivals, optionally trace-driven.

    rates: (..., n_bins) arrival rate (qps) per time bin; leading dims are
        scenario dims.  The profile tiles with period n_bins*bin_seconds.
    bin_seconds: 0-dim bin width in seconds.
    trace_gaps: optional (n,) interarrival gaps of a replayed trace.  When
        present the simulator consumes these instead of drawing gaps;
        ``rates`` then only provides the trace's mean rate.
    """

    rates: Tensor
    bin_seconds: Tensor
    trace_gaps: Optional[Tensor] = None

    # -- constructors ------------------------------------------------------

    @classmethod
    def stationary(cls, rate: TensorLike, *,
                   device: DeviceLike = DEFAULT_DEVICE,
                   dtype: torch.dtype = torch.float32) -> "ArrivalProcess":
        """Homogeneous Poisson at ``rate`` qps; any leading scenario shape."""
        r = _t(rate, device, dtype)
        return cls(rates=r[..., None],
                   bin_seconds=torch.tensor(1.0, dtype=dtype, device=device))

    @classmethod
    def piecewise(cls, rates: TensorLike, bin_seconds: float, *,
                  device: DeviceLike = DEFAULT_DEVICE,
                  dtype: torch.dtype = torch.float32) -> "ArrivalProcess":
        """Rate ``rates[..., i]`` on [i*bin, (i+1)*bin), tiling periodically."""
        return cls(rates=_t(rates, device, dtype),
                   bin_seconds=_t(bin_seconds, device, dtype))

    @classmethod
    def flash_crowd(
        cls,
        base_rate: TensorLike,
        *,
        burst_starts: Union[Sequence[float], float],
        burst_seconds: float,
        burst_multiplier: float = 5.0,
        period_seconds: float = 3600.0,
        bin_seconds: float = 60.0,
        device: DeviceLike = DEFAULT_DEVICE,
        dtype: torch.dtype = torch.float32,
    ) -> "ArrivalProcess":
        """Baseline load with flash-crowd burst windows.

        Rates are ``base_rate`` everywhere except on
        ``[start, start + burst_seconds)`` for each start in
        ``burst_starts`` (seconds into the period), where they are
        ``base_rate * burst_multiplier``.  A bin the (period-wrapped)
        burst window overlaps at all is elevated whole, so bursts shorter
        than a bin are never dropped.
        """
        n_bins = max(1, int(round(period_seconds / bin_seconds)))
        edges = np.arange(n_bins) * float(bin_seconds)
        starts = np.atleast_1d(np.asarray(burst_starts, dtype=np.float64))
        in_burst = np.zeros(n_bins, dtype=bool)
        for s in starts % float(period_seconds):
            rel = (edges - s) % float(period_seconds)
            in_burst |= (rel < float(burst_seconds)) | (
                rel > float(period_seconds) - float(bin_seconds))
        mult = torch.where(torch.as_tensor(in_burst, device=device),
                           torch.tensor(burst_multiplier, dtype=dtype,
                                        device=device),
                           torch.tensor(1.0, dtype=dtype, device=device))
        rates = _t(base_rate, device, dtype)[..., None] * mult
        return cls(rates=rates, bin_seconds=torch.tensor(
            float(bin_seconds), dtype=dtype, device=device))

    @classmethod
    def from_trace(cls, timestamps: TensorLike, *,
                   device: DeviceLike = DEFAULT_DEVICE,
                   dtype: torch.dtype = torch.float32) -> "ArrivalProcess":
        """Replay a measured (sorted, 1-D) arrival-timestamp trace.

        Gaps are differenced on the host in float64 BEFORE any float32
        conversion: near the end of a week-long window a float32
        timestamp only resolves 1/16 s, which would quantize sub-100 ms
        gaps to zero.  The gaps themselves survive float32 fine.
        """
        if isinstance(timestamps, Tensor):
            timestamps = timestamps.detach().cpu().double().numpy()
        t = np.asarray(timestamps, dtype=np.float64)
        gaps = np.diff(t, prepend=t[:1])
        span = max(float(t[-1] - t[0]), 1e-9)
        mean_rate = (t.shape[0] - 1) / span
        return cls(rates=torch.tensor([mean_rate], dtype=dtype,
                                      device=device),
                   bin_seconds=torch.tensor(1.0, dtype=dtype, device=device),
                   trace_gaps=_t(gaps, device, dtype))

    # -- derived quantities ------------------------------------------------

    @property
    def n_bins(self) -> int:
        return self.rates.shape[-1]

    @property
    def period_seconds(self) -> Tensor:
        return self.n_bins * self.bin_seconds

    @property
    def mean_rate(self) -> Tensor:
        """Per-scenario time-averaged rate, shape ``rates.shape[:-1]``."""
        return torch.mean(self.rates, dim=-1)

    @property
    def peak_rate(self) -> Tensor:
        return torch.amax(self.rates, dim=-1)

    def rate_at(self, t: TensorLike) -> Tensor:
        """Rate at absolute time ``t`` (scalar or per-scenario vector).

        The period wrap is a floor modulo (``torch.remainder``, the sign
        of the divisor, as jnp's ``%``), so negative times wrap forward.
        """
        t = torch.as_tensor(t, device=self.rates.device)
        idx = torch.floor(torch.remainder(t, self.period_seconds)
                          / self.bin_seconds).to(torch.int64)
        idx = torch.clamp(idx, 0, self.n_bins - 1)
        if self.rates.ndim == 1:
            return self.rates[idx]
        return torch.gather(self.rates, -1, idx[..., None])[..., 0]

    def scaled_by(self, scale: TensorLike) -> "ArrivalProcess":
        """Scenario-scaled copy: rates ``scale[..., None] * rates``."""
        s = _t(scale, self.rates.device, self.rates.dtype)
        return dataclasses.replace(self, rates=s[..., None] * self.rates)

    def normalized(self) -> "ArrivalProcess":
        """Copy with rates scaled to a time-averaged mean of 1 qps."""
        return dataclasses.replace(
            self, rates=self.rates / torch.clamp_min(
                self.mean_rate[..., None], 1e-30))

    def to(self, device: DeviceLike = None,
           dtype: Optional[torch.dtype] = None) -> "ArrivalProcess":
        """Copy with every tensor on ``device`` in ``dtype``."""
        def mv(x):
            return None if x is None else x.to(device=device, dtype=dtype)
        return ArrivalProcess(rates=mv(self.rates),
                              bin_seconds=mv(self.bin_seconds),
                              trace_gaps=mv(self.trace_gaps))
