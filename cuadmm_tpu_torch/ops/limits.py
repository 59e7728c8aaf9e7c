"""The card's own limits for ``normal_solver="auto"`` and the factor builds.

``auto`` (ops/chol.py) keeps the JAX package's rule past dense_chol_max:
the packed triangle if it streams at most 1.15x the band's bytes, else the
band if it fits, else packed if con_num allows, else sharded on a mesh,
else cg. The numbers that rule reads are the card's, derived here from its
memory (``torch.cuda.get_device_properties(d).total_memory``) and from
K3's measured solve times, not the JAX package's, which were sized for a
16 GB TPU chip.

Each mode's device-memory peak while its factor is built is written as

    peak(F) = multiple x F + constant

with F the factor's bytes: the packed triangle's T tiles of 1024^2 f32
(``tri_stream.make_layout``), the band's T tiles of B^2 f32, and for
precond the inverse factor's f32 square n_pad^2 (the build holds three
such squares: AA^T, its jittered clone and L, then L, the identity and
inv(L)). A limit is the largest factor whose peak fits in the card's
memory less ``HEADROOM`` of it, which the iteration's state, the CUDA
graphs' pool, the CUDA context and the allocator's slack take. The
multiples and constants below are fitted (``cuadmm_tpu_torch/card_fit.py``)
from ``torch.cuda.max_memory_allocated()`` over each build, on

    NVIDIA H100 80GB HBM3, 700.00 W

- packed: the 20x60 and 20x120 grid max-cuts (32,427 and 68,350
  constraints; 2.21 and 9.55 GB of tiles): 1.0156 F + 0.94 GB;
- banded: the same two grids under RCM (0.27 and 0.56 GB) and the
  synthetic PushBox N=30 band (n 154,256, bandwidth 20,512: 13.9 GB):
  1.0643 F + 0.012 GB;
- precond: the 20x60 and 20x80 grids (n_pad 32,512 and 44,416: 4.23 and
  7.89 GB squares): 2.9918 F - 0.009 GB;

by least squares, with the constant then raised until no measured peak
lies above the line. On that card (85.0 GB) they give precond to n_pad
79,872, packed to 191,488 constraints and bands to 71.9 GB.

Dense A (``chol._device_factorize``) is built on the card when
con_num * vec_len * itemsize + 2 * con_num^2 * itemsize (A beside AA^T and
the jitter clone) fits ``dense_a_budget``, the memory left to the build
beside precond's constant; otherwise AA^T is formed on the host.

K3's band model, fitted from its solve times at B in {256, 512, 1024} on
four bands (the same card; ``card_fit.py``), is

    t_solve = 2 (T B^2 4 / bytes_per_s + T tile_s + nb (step_s + B row_s))

two sweeps, each streaming its T tiles once, paying a fixed cost a tile
(its B/8 work items), and waiting at each of its nb dependent block steps
for the step's diagonal and last off-diagonal tile, read by B/8 CTAs
(a cost that grows with B). The two-term form bytes / rate + nb x step
ranked B = 1024 first at the 20x120 grid's band when B = 512 had run 8%
faster (nbw 1: every tile is on the chain of steps); this one ranks the
three blocks as measured on all four bands but the grid's, where B 1024
and 512 tie within 2.5% (PERF.md, PR 11). The JAX package's TPU model is
this form without the step terms, with its TPU's rates
(cuadmm_tpu/ops/tri_stream.py:463-478). ``tri_stream.make_band_layout``
picks the B the model predicts fastest.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from cuadmm_tpu_torch.ops.precond_apply import LANE

# Share of the card's memory no factor build may take (the state, the
# graphs' pool, the context and the allocator's slack). The largest state
# measured beside a factor on the card, QUASAR-500's graphed run, peaks at
# 1.46 GB in all (PERF.md, PR 10).
HEADROOM = 0.10

PACKED_BLOCK = 1024  # tri_stream.make_layout's block past 2,048 constraints


class PeakModel(NamedTuple):
    """A mode's build peak, ``multiple`` x factor bytes + ``constant``."""

    multiple: float
    constant: float

    def __call__(self, factor_bytes: float) -> float:
        return self.multiple * factor_bytes + self.constant


# Fitted on NVIDIA H100 80GB HBM3, 700.00 W (card_fit.py; PERF.md, PR 11).
PACKED_PEAK = PeakModel(1.0155765206473215, 938720099.0)
BAND_PEAK = PeakModel(1.0642607521221874, 12113848.0)
PRECOND_PEAK = PeakModel(2.991796406750399, -8626858.0)


@dataclasses.dataclass(frozen=True)
class BandModel:
    """K3's solve time for a band layout of T tiles of B^2 f32 in nb block
    rows: ``2 (T B^2 4 / bytes_per_s + T tile_s + nb (step_s + B row_s))``."""

    bytes_per_s: float
    tile_s: float
    step_s: float
    row_s: float

    def __call__(self, T: int, B: int, nb: int) -> float:
        return 2.0 * (T * B * B * 4 / self.bytes_per_s + T * self.tile_s + nb * (self.step_s + B * self.row_s))


# Fitted on NVIDIA H100 80GB HBM3, 700.00 W (card_fit.py; PERF.md, PR 11).
BAND_MODEL = BandModel(bytes_per_s=2826837042583.1016, tile_s=1.0427952326990273e-07,
                       step_s=1.3379230425212235e-06, row_s=2.0193962745902527e-09)


@dataclasses.dataclass(frozen=True)
class CardLimits:
    """What ``auto`` and the factor builds may place on one card."""

    total_bytes: int
    packed_max_con: int  # largest con_num auto routes to the packed triangle
    band_max_bytes: int  # largest f32 band factor auto places
    dense_a_budget: int  # bytes for dense A beside AA^T and its jitter clone
    precond_max_n_pad: int  # largest n_pad of precond's (or split's prefix's) inverse factor
    band_model: BandModel  # K3's solve time: picks the band's block


def available(total_bytes: int) -> int:
    """The bytes a factor build may take: the card less ``HEADROOM``."""
    return int(total_bytes * (1.0 - HEADROOM))


def packed_bytes(con_num: int) -> int:
    """The packed triangle's f32 bytes at B = 1024 (``tri_stream.make_layout``)."""
    nb = -(-con_num // PACKED_BLOCK)
    return nb * (nb + 1) // 2 * PACKED_BLOCK * PACKED_BLOCK * 4


def limits_for(total_bytes: int, band_model: BandModel = BAND_MODEL) -> CardLimits:
    """The limits of a card with ``total_bytes`` of memory (a pure function:
    the CPU tests call it with any size)."""
    avail = available(total_bytes)
    nb = 0  # the most block rows whose packed triangle's build fits
    while PACKED_PEAK(packed_bytes((nb + 1) * PACKED_BLOCK)) <= avail:
        nb += 1
    band = max(0, math.floor((avail - BAND_PEAK.constant) / BAND_PEAK.multiple))
    n_pad = math.isqrt(max(0, int((avail - PRECOND_PEAK.constant) / (PRECOND_PEAK.multiple * 4))))
    n_pad -= n_pad % LANE
    while n_pad and PRECOND_PEAK(4.0 * n_pad * n_pad) > avail:  # isqrt's rounding
        n_pad -= LANE
    return CardLimits(
        total_bytes=int(total_bytes),
        packed_max_con=nb * PACKED_BLOCK,
        band_max_bytes=band,
        dense_a_budget=max(0, int(avail - PRECOND_PEAK.constant)),
        precond_max_n_pad=n_pad,
        band_model=band_model,
    )


def card_limits(device) -> CardLimits:
    """The limits of CUDA ``device``, from its memory and ``BAND_MODEL``.
    Raises on any other device: the CPU never takes the accelerator's
    routes."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"card_limits needs a CUDA device, got {device}")
    return limits_for(torch.cuda.get_device_properties(device).total_memory)
