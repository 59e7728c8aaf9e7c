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
- banded: the same two grids under RCM (0.54 and 1.12 GB at B 1024, nbw
  1: the band and its one-hop derived tiles, ``tri_stream.band_bytes``)
  and the synthetic PushBox N=30 band (n 154,256, bandwidth 20,512: 13.9
  GB, two-hop): 1.0502 F + 0.212 GB (the derived tiles' f64 products,
  8 tiles at a time, take the constant);
- precond: the 20x60 and 20x80 grids (n_pad 32,512 and 44,416: 4.23 and
  7.89 GB squares): 2.9918 F - 0.009 GB;

by least squares, with the constant then raised until no measured peak
lies above the line. On that card (85.0 GB) they give precond to n_pad
79,872, packed to 191,488 constraints and bands to 72.7 GB held: a band
of nbw <= NBW_CHAIN takes its derived tiles where the two fit that
(``band_form``), and runs the two-hop form on the band alone where only
the band does.

Dense A (``chol._device_factorize``) is built on the card when
con_num * vec_len * itemsize + 2 * con_num^2 * itemsize (A beside AA^T and
the jitter clone) fits ``dense_a_budget``, the memory left to the build
beside precond's constant; otherwise AA^T is formed on the host.

K3's band model, fitted from its solve times at B in {256, 512, 1024} on
four bands (the same card; ``card_fit.py``), is one form's terms for each
of K3's two forms (csrc/tri_stream.cu):

    t_solve = 2 (T B^2 4 / bytes_per_s + T tile_s + nb (step_s + B row_s))

two sweeps, each streaming its T tiles once, paying a fixed cost a tile
and a cost at each of its nb dependent block steps. In the two-hop form
(nbw > NBW_CHAIN) a step waits for its diagonal and its last off-diagonal
tile, read by B/8 CTAs each (a cost that grows with B); in the one-hop
form one hop a step remains, a fixed 1.1 us, and no cost a tile (PERF.md
§6). Both rank the three blocks as measured on all four bands; the
20x120 grid's band, whose blocks tied in the two-hop form, runs B 512
fastest in the one-hop form (0.441 against 0.518 ms at B 1024). The JAX
package's TPU model is the two-hop form without the step terms, with its
TPU's rates (cuadmm_tpu/ops/tri_stream.py:463-478).
``tri_stream.make_band_layout`` picks the B the model predicts fastest.

K3's third form, "segments" (``tri_stream.band_segments_solve``), holds
no tile: where the band's RCM order falls apart into independent
segments (no nonzero crosses a cut), each segment is one thread's chain
of forward and backward substitution in one launch, so a solve costs a
launch, the staging of its bytes and the longest chain. Its model,
fitted the same way (``card_fit.py``: solves of synthetic bands of
139,192 rows in segments of 1 to 512 rows at bandwidth 4 and 16, within
14% of each),

    t_solve = fixed_s + n (4 (bw + 1) + 16) / bytes_per_s + max_seg (bw + 1) entry_s,

a launch, the band's f32 rows with r and y in f64 staged once, and each
of the longest chain's rows paying for its bw + 1 terms, is set against the tile forms' model of the same band: the build takes
the segments form where it is faster, the band is at most
``SEGMENT_MAX_BW`` wide and no segment is longer than
``SEGMENT_MAX_ROWS`` (both what a CTA's shared memory stages).
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


# Fitted on NVIDIA H100 80GB HBM3, 700.00 W (card_fit.py; PERF.md §6).
PACKED_PEAK = PeakModel(1.0155765206473215, 938720099.0)
BAND_PEAK = PeakModel(1.0502401146889744, 212103896.0)
PRECOND_PEAK = PeakModel(2.991796406750399, -8626858.0)


# The widest block band (nbw) K3 runs in its one-hop form
# (ops/tri_stream.py), whose derived tiles add 2 nbw tiles a block row:
# it ran 1.4-1.8x faster than the two-hop form at nbw 1-6 (PERF.md §6).
NBW_CHAIN = 4


def band_held_bytes(T: int, B: int, nb: int, form: str) -> int:
    """The f32 bytes a band of T tiles of B^2 in nb block rows holds in
    K3's ``form``: its tiles, and in the one-hop form ("chain") the 2 nb
    nbw derived tiles beside them."""
    extra = 2 * (T - nb) if form == "chain" else 0  # T - nb = nb nbw
    return (T + extra) * B * B * 4


def band_form(T: int, B: int, nb: int, max_bytes: "int | None" = None) -> str:
    """K3's form for a band of T tiles of B^2 in nb block rows, nbw = T / nb
    - 1: "chain" (one-hop) at nbw <= NBW_CHAIN where the band with its
    derived tiles fits ``max_bytes`` (None: no limit), else "two_hop", which
    holds the band alone. ``auto`` places a band whose two-hop bytes fit
    ``CardLimits.band_max_bytes``; this picks its form, K3's model its time
    and the build its derived tiles."""
    if T // nb - 1 > NBW_CHAIN:
        return "two_hop"
    if max_bytes is not None and band_held_bytes(T, B, nb, "chain") > max_bytes:
        return "two_hop"
    return "chain"


@dataclasses.dataclass(frozen=True)
class BandModel:
    """K3's solve time for a band layout of T tiles of B^2 f32 in nb block
    rows: ``2 (T B^2 4 / bytes_per_s + T tile_s + nb (step_s + B row_s))``,
    the two-hop form's terms; ``one_hop`` (a BandModel of its own terms)
    stands for the bands that run the one-hop form, ``band_form(T, B, nb,
    max_bytes)`` (None: these terms for every band). ``max_bytes``: the
    card's ``band_max_bytes`` (``CardLimits.bound_band_model``), so that a
    block whose derived tiles do not fit is timed in the two-hop form it
    runs."""

    bytes_per_s: float
    tile_s: float
    step_s: float
    row_s: float
    one_hop: "BandModel | None" = None
    max_bytes: "int | None" = None

    def __call__(self, T: int, B: int, nb: int) -> float:
        if self.one_hop is not None and band_form(T, B, nb, self.max_bytes) == "chain":
            return self.one_hop(T, B, nb)
        return 2.0 * (T * B * B * 4 / self.bytes_per_s + T * self.tile_s + nb * (self.step_s + B * self.row_s))


# Fitted on NVIDIA H100 80GB HBM3, 700.00 W (card_fit.py; PERF.md §6).
BAND_MODEL = BandModel(bytes_per_s=2606775805619.3306, tile_s=1.0361712840547813e-07,
                       step_s=1.5921109713602756e-06, row_s=4.628687237513854e-10,
                       one_hop=BandModel(bytes_per_s=3182356971592.5957, tile_s=0.0,
                                         step_s=1.110786131302426e-06, row_s=0.0))


# The segments form's bounds: a CTA of csrc/tri_stream.cu's segments
# kernel stages its rows (f64 solution, bw + 1 f32 factor entries each) in
# 48 KB of shared memory, 646 rows at bandwidth 16.
SEGMENT_MAX_BW = 16
SEGMENT_MAX_ROWS = 512


@dataclasses.dataclass(frozen=True)
class SegmentModel:
    """K3's segments form: the seconds of a solve of ``n`` rows at
    bandwidth ``bw`` whose longest segment has ``max_seg`` rows,
    ``fixed_s + n (4 (bw + 1) + 16) / bytes_per_s + max_seg (bw + 1)
    entry_s``."""

    fixed_s: float
    bytes_per_s: float
    entry_s: float

    def __call__(self, n: int, bw: int, max_seg: int) -> float:
        return self.fixed_s + n * (4 * (bw + 1) + 16) / self.bytes_per_s + max_seg * (bw + 1) * self.entry_s


# Fitted on NVIDIA H100 80GB HBM3, 700.00 W (card_fit.py's segment_times; PERF.md §6).
SEGMENT_MODEL = SegmentModel(fixed_s=1.05170497547464e-06, bytes_per_s=1203080985128.8613,
                             entry_s=3.4380009650419183e-08)


def segment_form(model: "SegmentModel | None", n: int, bw: int, max_seg: int, tile_s: float) -> bool:
    """Whether a band of ``n`` rows and bandwidth ``bw`` whose longest
    independent segment has ``max_seg`` rows takes K3's segments form:
    within SEGMENT_MAX_BW and SEGMENT_MAX_ROWS, and faster by ``model``
    than ``tile_s``, the tile forms' modelled solve of the same band. No
    model: never."""
    return (model is not None and bw <= SEGMENT_MAX_BW and max_seg <= SEGMENT_MAX_ROWS
            and model(n, bw, max_seg) < tile_s)


@dataclasses.dataclass(frozen=True)
class CardLimits:
    """What ``auto`` and the factor builds may place on one card."""

    total_bytes: int
    packed_max_con: int  # largest con_num auto routes to the packed triangle
    band_max_bytes: int  # largest f32 band auto places, derived tiles included where it takes them
    dense_a_budget: int  # bytes for dense A beside AA^T and its jitter clone
    precond_max_n_pad: int  # largest n_pad of precond's (or split's prefix's) inverse factor
    band_model: BandModel  # K3's solve time: picks the band's block
    segment_model: "SegmentModel | None" = SEGMENT_MODEL  # the segments form's (None: tile forms only)

    def bound_band_model(self):
        """``band_model`` as the card's band is picked with it: a BandModel
        bound to ``band_max_bytes`` (``band_form``); any other model as it
        is."""
        if isinstance(self.band_model, BandModel):
            return dataclasses.replace(self.band_model, max_bytes=self.band_max_bytes)
        return self.band_model


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
