"""Batch decode: noisy wav -> enhanced wav (+ SegSNR/LSD info).

Port of ``tpu_se/infer/decode.py``, the ``Test_code/decode.m`` pipeline:

    wav -> LPS -> Z-score -> edge-replicated 7-frame splice -> DNN forward
        -> de-normalize (+ blend) -> exp/2 + noisy phase -> OLA -> int16 wav

Everything between the frames and the OLA waveform runs on one device,
with the LPS front end in the hand-written kernel on a CUDA device.

Shapes come in buckets, as the reference's do, so that a captured program
repeats: the frame axis is zero-padded to a multiple of
``DECODE_PAD_BUCKET`` = 64 frames and a batch (``enhance_batch``,
``enhance_batch_waves``) to a multiple of ``BATCH_BUCKET`` = 4 utterances;
``enhance`` keeps its one row, as ``_decode_device`` has no batch axis.
Padded rows and frames are zeros and change nothing: the splice clamps at
the last valid frame, the ``"auto"`` blend sums valid rows only, the OLA
drops invalid rows; the outputs are cut back to each utterance.  The
reference pads ``enhance`` and the batches to 256 frames
(``FRAME_BUCKET``) and only ``enhance_lps`` to 64; the port takes 64 for
all four: at 256 a 1 s utterance (~62 frames) would run 4x its products,
and 7.2 s (448 frames = 7 x 64) would run as 512 (+14 %).

On a card (``graph=True``, without a mesh or under an NCCL one) each
padded shape is one captured ``torch.cuda.CUDAGraph``, replayed:
``jax.jit`` of ``_decode_device``, ``_decode_device_batch``,
``_decode_device_batch_waves`` and ``_enhance_lps`` (under their
shardings) becomes a graph per (program, padded shape, compute dtype,
blend), captured after one eager run of its first call on a side stream
(which builds the cuFFT plans, the cuBLAS handles and the NCCL
communicators that a capture cannot; ``utils/graphs.py``).  The graphs of
one ``Enhancer`` share one memory pool and are kept up to
``MAX_DECODE_GRAPHS``, least recently used out.  A call copies its inputs
into the graph's static tensors (zeros outside its shape) and reads the
static outputs before the next replay.  The weights (and their bfloat16
copy) are frozen, so the graphs read them by address.  The CPU, gloo and
``graph=False`` run the same programs eagerly at the same padded shapes.
A replay adds its capture's LPS launches to ``lps_kernel.launches`` (one
per call, as eager) and its collectives to ``Mesh.traffic``.

With smoothing or postprocessing (``smooth``, ``smooth_strength``,
``postprocess``) ``enhance`` is staged as the reference stages it: one
program from the frames to the noisy and the enhanced LPS, the options in
numpy on the host, and one program of the synthesis, both at the padded
T and each its own graph.

Under a mesh (``Enhancer(mesh=)``, one process per device) the weights are
whole on every rank and only the ``data`` axis splits the work, as the
reference shards its frames or its batch over ``data`` and replicates over
``model``: both pad buckets are rounded up to a multiple of ``data``
(``tpu_se``'s ``_pad_bucket``), a batch's data index decodes its block of
rows, and one utterance's padded frame axis is split in contiguous blocks,
each with the ``context // 2`` frames on either side that its splice reads
(clamped at the last valid frame on the device, from ``n_valid``; a block
wholly past it reads inside its window, and its rows are dropped).  The
blocks are all-gathered inside the program, so every rank returns what one
device returns and the OLA sees the whole utterance.  Every rank makes the
same calls, so every rank captures, replays and evicts the same graphs;
each holds its collectives and is named to ``release_on_shutdown``.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from tpu_se_torch.dsp.analysis import (
    LOG_FLOOR, dft_basis, frame_signal, hamming_window, lps_from_frames,
    rate_config,
)
from tpu_se_torch.dsp.metrics import segsnr_lsd_pair
from tpu_se_torch.dsp.synthesis import _synth_and_ola
from tpu_se_torch.io import read_norm, read_wav, read_wts, write_wav
from tpu_se_torch.models.ffn import FFN, params_from_numpy
from tpu_se_torch.ops import lps_kernel
from tpu_se_torch.parallel.distributed import release_on_shutdown
from tpu_se_torch.utils import graphs
from tpu_se_torch.utils.device import resolve_compute_dtype, resolve_device

# Pad buckets (tpu_se/infer/decode.py:34, its Enhancer.BATCH_BUCKET): the
# frame axis to a multiple of 64 frames, a batch to a multiple of 4.
DECODE_PAD_BUCKET = 64
BATCH_BUCKET = 4
# Captured programs an Enhancer keeps (least recently used out).
MAX_DECODE_GRAPHS = 16

# Decode calls run as replays of a captured graph, and graphs captured,
# over every Enhancer of the process.
decodes_replayed = 0
decode_graphs_captured = 0
# The launch counters a decode program advances (``graphs.read_counts``).
DECODE_COUNTERS = ((lps_kernel, "launches"),)

# Adaptive-blend map (tpu_se/infer/decode.py): lam = LMAX *
# exp(-suppression_dB / TAU), clipped to [0, 0.9], from the utterance's
# mean suppression (noisy minus enhanced LPS, in dB).
BLEND_AUTO_LMAX = 0.8
BLEND_AUTO_TAU_DB = 20.0
BLEND_AUTO_MAX = 0.9
_DB_PER_NEPER = 10.0 / math.log(10.0)


def _check_smooth_strength(strength, smooth_flag: bool = False):
    """Resolve a smoothing-strength setting to 0.0 (off), (0, 1], or 'auto'.

    ``strength=None`` defers to the binary ``smooth`` flag (the
    reference's compile-time SMOOTHPROCESS: on means s=1).  A non-zero
    strength turns smoothing on by itself; 0 turns it off even when
    ``smooth_flag`` is set.
    """
    if strength is None:
        return 1.0 if smooth_flag else 0.0
    if isinstance(strength, str) and strength == "auto":
        return "auto"
    try:
        val = float(strength)
    except (TypeError, ValueError):
        raise ValueError(f"smooth_strength must be 'auto' or in [0, 1], "
                         f"got {strength!r}")
    if not 0.0 <= val <= 1.0:
        raise ValueError(f"smooth_strength must be 'auto' or in [0, 1], "
                         f"got {strength!r}")
    return val


def _check_blend(blend):
    """Validate a blend setting: 'auto' or a numeric value in [0, 1)."""
    if isinstance(blend, str) and blend == "auto":
        return blend
    try:
        val = float(blend)
    except (TypeError, ValueError):
        raise ValueError(f"blend must be 'auto' or in [0, 1), got {blend!r}")
    if not 0.0 <= val < 1.0:
        raise ValueError(f"blend must be 'auto' or in [0, 1), got {blend!r}")
    return val


def _enhance_lps(model: FFN, lps: torch.Tensor, mean: torch.Tensor,
                 inv_std: torch.Tensor, n_valid: torch.Tensor,
                 context: int = 7, blend=0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 cast_weights: list | None = None, block: tuple | None = None,
                 mesh=None) -> torch.Tensor:
    """Normalized forward over edge-replicated spliced frames, on device.

    ``lps`` [B, T, D] padded, ``n_valid`` [B] true frame counts.  The
    splice clamps at ``n_valid - 1``, so the last frames replicate the
    final TRUE frame (``frame_expand.m:19-22``), never a pad row.
    ``blend`` in [0, 1) moves the enhanced LPS that fraction back toward
    the noisy LPS (log domain); ``"auto"`` picks the fraction per
    utterance from the model's mean suppression over its valid rows.
    ``compute_dtype`` and ``cast_weights`` go to ``FFN.forward``.

    ``block=(first, lo, hi)``: ``lps`` holds frames [first, first + T) of
    the utterances and the output is frames [lo, hi), a rank's share of
    them; ``mesh`` then adds the ``"auto"`` blend's sums over its data
    axis, so the fraction is the whole utterance's.
    """
    b, t, d = lps.shape
    first, lo, hi = (0, 0, t) if block is None else block
    normed = (lps - mean) * inv_std
    half = (context - 1) // 2
    steps = torch.arange(lo, hi, device=lps.device)
    idx = (steps[:, None]
           + torch.arange(-half, half + 1, device=lps.device)[None, :])
    last = (n_valid - 1).clamp(min=0)[:, None, None]
    idx = torch.minimum(idx.clamp(min=0)[None], last)             # [B, T, C]
    if block is not None:
        # A block wholly past the utterance's end reads the first frame of
        # its window: its rows are invalid and dropped.
        idx = idx.clamp(min=first) - first
    rows = torch.arange(b, device=lps.device)[:, None, None]
    n = hi - lo
    x = normed[rows, idx].reshape(b * n, context * d)
    enh = model(x, compute_dtype=compute_dtype,
                cast_weights=cast_weights).reshape(b, n, d) / inv_std + mean
    if block is not None:
        # The noisy LPS of the output frames (past the utterance's end, of
        # a frame of the window: those rows are invalid and dropped).
        lps = lps[rows[..., 0],
                  torch.minimum(steps[None], last[..., 0]).clamp(min=first)
                  - first]
    if blend == "auto":
        valid = (steps[None, :] < n_valid[:, None]).to(lps.dtype)[..., None]
        sums = ((lps - enh) * valid).sum(dim=(1, 2))
        if mesh is not None:
            sums = mesh.all_reduce_sum(sums, "data")
        supp_db = (sums / (n_valid.clamp(min=1) * d) * _DB_PER_NEPER)
        lam = (BLEND_AUTO_LMAX
               * torch.exp(-supp_db.clamp(min=0.0) / BLEND_AUTO_TAU_DB)
               ).clamp(0.0, BLEND_AUTO_MAX)[:, None, None]
        enh = (1.0 - lam) * enh + lam * lps
    elif blend:
        enh = (1.0 - blend) * enh + blend * lps
    return enh


def _frame_block(t: int, context: int, mesh) -> tuple[int, int, int, int]:
    """A data index's share of a T-frame axis (T a multiple of the data
    axis' size): (first, lo, hi, last) -- its output frames [lo, hi) and
    the frames [first, last) its splice reads, inside [0, T)."""
    half = (context - 1) // 2
    per = t // mesh.data
    lo = mesh.data_rank * per
    return max(lo - half, 0), lo, lo + per, min(lo + per + half, t)


def _enhance_split(model: FFN, lps: torch.Tensor, t: int, mesh,
                   mean: torch.Tensor, inv_std: torch.Tensor,
                   n_valid: torch.Tensor, context: int, blend,
                   compute_dtype: torch.dtype, cast_weights: list | None
                   ) -> torch.Tensor:
    """``_enhance_lps`` of a T-frame axis split over ``mesh``'s data axis:
    ``lps`` holds this rank's window of frames (``_frame_block``), the
    blocks are all-gathered -> the whole [B, T, D]."""
    first, lo, hi, _ = _frame_block(t, context, mesh)
    out = _enhance_lps(model, lps, mean, inv_std, n_valid, context, blend,
                       compute_dtype, cast_weights, (first, lo, hi), mesh)
    return mesh.all_gather(out, 1, "data")


def _decode_core(model: FFN, frames: torch.Tensor, mean: torch.Tensor,
                 inv_std: torch.Tensor, n_valid: torch.Tensor,
                 basis: torch.Tensor, window: torch.Tensor, frame_shift: int,
                 context: int = 7, blend=0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 cast_weights: list | None = None, mesh=None):
    """The whole decode on one device: noisy frames [B, T, len] ->
    (OLA waveform [B, S], de-windowed recon frames [B, T, len],
    enhanced LPS [B, T, bins]).  ``basis`` and ``window`` are the
    analysis matrix and Hamming window, already on the device.  With
    ``mesh`` the frame axis (T a multiple of its data axis) is split: this
    rank's window of frames through the LPS and the network, the blocks
    all-gathered, then the synthesis of the whole utterance."""
    b, t, length = frames.shape
    if mesh is None:
        lps = lps_from_frames(frames.reshape(b * t, length),
                              basis=basis).reshape(b, t, -1)
        enh = _enhance_lps(model, lps, mean, inv_std, n_valid, context,
                           blend, compute_dtype, cast_weights)
    else:
        first, _, _, last = _frame_block(t, context, mesh)
        lps = lps_from_frames(frames[:, first:last].reshape(-1, length),
                              basis=basis).reshape(b, last - first, -1)
        enh = _enhance_split(model, lps, t, mesh, mean, inv_std, n_valid,
                             context, blend, compute_dtype, cast_weights)
    valid = (torch.arange(t, device=frames.device)[None, :]
             < n_valid[:, None])
    wave, recon = _synth_and_ola(enh, frames, valid, frame_shift,
                                 window=window)
    return wave, recon, enh


# smooth_strength="auto": fractional SMOOTHPROCESS gated by the input's
# temporal impulsiveness (tpu_se/infer/decode.py):
# s_eff = SM_AUTO_S * clip((D1 - dyn)/(D1 - D0), 0, 1), with dyn the mean
# |delta mean-frame-dB| of the noisy LPS.
SM_AUTO_S = 0.5
SM_AUTO_D0 = 2.0          # full strength at/below this dyn
SM_AUTO_D1 = 3.0          # zero strength at/above


def smooth_dyn_statistic(noisy_lps: np.ndarray) -> float:
    """The gate statistic: mean |Δ mean-frame-dB| of the noisy LPS."""
    frame_db = noisy_lps.mean(axis=1) * (10.0 / np.log(10.0))
    if len(frame_db) < 2:
        return float(SM_AUTO_D1)      # too short to judge -> smoothing off
    return float(np.abs(np.diff(frame_db)).mean())


def _smooth_auto_strength(noisy_lps: np.ndarray) -> float:
    dyn = smooth_dyn_statistic(noisy_lps)
    return SM_AUTO_S * float(np.clip((SM_AUTO_D1 - dyn)
                                     / (SM_AUTO_D1 - SM_AUTO_D0), 0.0, 1.0))


SWITCHPOINT = 36          # LogSpec2Wav.c:76 — low/high band split
THRESHOLD1 = -2.1         # max suppression, bins 0..36   (:77)
THRESHOLD2 = -3.43        # max suppression, bins 37..256 (:78)
NOISE_FRAME_NUM = 10      # leading frames treated as noise (:80)
SMOOTH_WIN = 1            # running-min half-window (:75)


def postprocess_lps(enh_lps: np.ndarray, noisy_lps: np.ndarray) -> np.ndarray:
    """The vocoder's POSTPROCESS option (``LogSpec2Wav.c:655-679``):
    floor the enhanced LPS at the noisy LPS plus a per-band threshold,
    bounding the maximum suppression (~9 dB low bins, ~15 dB high bins)."""
    floor = noisy_lps + np.where(
        np.arange(enh_lps.shape[1]) <= SWITCHPOINT, THRESHOLD1, THRESHOLD2)
    return np.maximum(enh_lps, floor).astype(np.float32)


def smooth_power(power: np.ndarray) -> np.ndarray:
    """The vocoder's SMOOTHPROCESS option (``LogSpec2Wav.c:497-546``):
    per frequency bin, frames whose power is below the max over the first
    NOISE_FRAME_NUM frames are replaced with a running min over the
    +-SMOOTH_WIN neighborhood (of the ORIGINAL values)."""
    t = power.shape[0]
    if t <= 2 * SMOOTH_WIN:
        return power
    noise_max = power[:NOISE_FRAME_NUM].max(axis=0, keepdims=True)
    out = power.copy()
    window_min = power.copy()
    for off in range(1, SMOOTH_WIN + 1):
        window_min[off:] = np.minimum(window_min[off:], power[:-off])
        window_min[:-off] = np.minimum(window_min[:-off], power[off:])
    region = np.zeros_like(power, dtype=bool)
    region[SMOOTH_WIN: t - SMOOTH_WIN] = True
    mask = region & (power < noise_max)
    out[mask] = window_min[mask]
    return out


def trunc_int16(wave: torch.Tensor) -> torch.Tensor:
    """float wave -> int16 on its device, as ``np.trunc(x).astype(np.int16)``.

    Goes through int32: a float -> int16 cast out of range is undefined on
    the GPU, while int32 -> int16 keeps the low 16 bits, which is what
    numpy's cast gives (a loud output wraps) for |x| < 2^31.
    """
    return wave.trunc().to(torch.int32).to(torch.int16)


def _exp_floored(lps: np.ndarray) -> np.ndarray:
    return np.where(lps < LOG_FLOOR, np.exp(LOG_FLOOR), np.exp(lps))


def _roundup(n: int, bucket: int) -> int:
    return -(-n // bucket) * bucket


def _fill(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``src`` into the leading corner of ``dst`` (any devices), zeros in
    the rest of ``dst``."""
    if src.shape == dst.shape:
        dst.copy_(src)
    else:
        dst.zero_()
        dst[tuple(slice(0, n) for n in src.shape)].copy_(src)


def _pad_to(src: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    """``src`` on ``device``, zero-padded at the end of each axis to
    ``shape``."""
    if tuple(src.shape) == shape:
        return src.to(device)
    out = torch.empty(shape, dtype=src.dtype, device=device)
    _fill(out, src)
    return out


@dataclass(eq=False)
class _DecodeGraph(graphs.Releasable):
    """One decode program captured at one padded shape: its key, its
    static inputs and outputs, and what one replay adds to the LPS kernel's
    launches and the mesh's ``Mesh.traffic`` (``graphs.read_counts``)."""
    key: tuple | None
    graph: torch.cuda.CUDAGraph
    stream: torch.cuda.Stream
    inputs: tuple
    outputs: tuple
    counts: tuple


class Enhancer:
    """Loaded model + normalization stats on ``device``, ready to enhance.

    ``device`` is ``"cuda"`` (default; raises without a card) or ``"cpu"``.
    Quality options as in ``tpu_se.infer.Enhancer``: ``blend`` (fixed or
    ``"auto"``), ``smooth_strength`` (fixed or ``"auto"``; non-zero implies
    smoothing, 0 is off, ``smooth=True`` alone is the reference's s=1) and
    ``postprocess``; smoothing and postprocessing run on the host between
    the forward pass and synthesis (``LogSpec2Wav.c:497-546,655-679``).
    ``compute_dtype`` (``torch.float32``, ``torch.bfloat16`` or their names)
    is the type of the network's product operands; the weights are frozen,
    so their reduced copy is made here, once, and every decode reads it.

    ``mesh`` (a ``tpu_se_torch.parallel.Mesh``; every rank constructs its
    own ``Enhancer`` and makes the same calls): the decode runs on the
    mesh's device and its data axis splits the work (see the module's
    docstring); every call returns, on every rank, what one device's
    returns.

    ``graph``: on a card, without a mesh or under an NCCL one, each padded
    shape's program is captured once and replayed (the module's
    docstring); a capture that fails raises.  ``graph=False`` runs the
    same programs eagerly at the same padded shapes, the reference the
    replays are held to; so do gloo and the CPU.
    """

    def __init__(self, wts_path, norm_path, device="cuda", context: int = 7,
                 postprocess: bool = False, smooth: bool = False,
                 smooth_strength=None, sample_rate: int = 16000,
                 blend=0.0, compute_dtype=torch.float32, mesh=None,
                 graph: bool = True):
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.model = params_from_numpy(read_wts(wts_path), self.device)
        self.cast_weights = (
            None if self.compute_dtype == torch.float32
            else self.model.cast_weights(self.compute_dtype))
        dim = self.model.biases[-1].shape[0]
        (self.frame_length, self.frame_shift,
         fft_length) = rate_config(sample_rate)
        if fft_length // 2 + 1 != dim:
            raise ValueError(f"model dim {dim} != {fft_length // 2 + 1} "
                             f"bins at {sample_rate} Hz")
        self.sample_rate = sample_rate
        mean, inv_std = read_norm(norm_path, dim)
        self.mean = torch.from_numpy(mean).to(self.device)
        self.inv_std = torch.from_numpy(inv_std).to(self.device)
        self.basis = dft_basis(self.frame_length, self.device)
        self.window = torch.from_numpy(
            hamming_window(self.frame_length)).to(self.device)
        self.context = context
        self.postprocess = postprocess
        self.smooth_strength = _check_smooth_strength(smooth_strength,
                                                      smooth)
        self.smooth = self.smooth_strength != 0.0
        self.blend = _check_blend(blend)
        self.replays = graph and graphs.replays(self.device, mesh)
        # The captured programs by key, least recently used first; their
        # shared memory pool and the stream they were captured on.
        self._graphs: OrderedDict = OrderedDict()
        self._pool = None
        self._stream = None

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _bucket(self, bucket: int) -> int:
        """A pad bucket, rounded up to a multiple of the data axis under a
        mesh (``tpu_se``'s ``_pad_bucket``)."""
        return bucket if self.mesh is None else _roundup(bucket,
                                                         self.mesh.data)

    def _padded_shape(self, b: int, t: int, batch: bool) -> tuple[int, int]:
        """(B_pad, T_pad) of a call with ``b`` rows of ``t`` frames: T up
        to a multiple of ``DECODE_PAD_BUCKET``; with ``batch``, B up to a
        multiple of ``BATCH_BUCKET``; under a mesh both buckets rounded up
        to a multiple of the data axis, as the reference rounds them."""
        t_pad = _roundup(t, self._bucket(DECODE_PAD_BUCKET))
        if not batch:
            return b, t_pad
        return _roundup(b, self._bucket(BATCH_BUCKET)), t_pad

    def _my_rows(self, b_pad: int, *tensors: torch.Tensor) -> list:
        """Under a mesh, this data index's block of the ``b_pad`` rows of a
        batch (fewer, or none, where the tensors hold fewer rows: the
        program's padding fills them)."""
        per = b_pad // self.mesh.data
        lo = self.mesh.data_rank * per
        return [t[lo:lo + per] for t in tensors]

    def _gathered(self, fn):
        """``fn``, a program of this rank's rows, with its outputs
        all-gathered over the data axis: every rank's rows, in order."""
        def run(*inputs):
            return tuple(self.mesh.all_gather(o, 0, "data")
                         for o in fn(*inputs))
        return run

    @torch.inference_mode()
    def _run(self, kind: str, fn, inputs: tuple, shapes: tuple) -> tuple:
        """``fn(*inputs)`` -> its tuple of outputs, each input zero-padded
        at the end of its axes to its shape in ``shapes`` (the inputs may
        lie on the host).  Eager, or with ``self.replays`` a replay of the
        graph of (``kind``, ``shapes``, compute dtype, blend), captured
        at its first call.  A replay's outputs are the graph's static
        tensors: the next replay of any graph of this ``Enhancer`` may
        overwrite them, so the caller reads them before its next call.
        The key holds nothing a rank alone knows, so under a mesh every
        rank captures, replays and evicts the same keys in the same
        order."""
        global decodes_replayed
        if not self.replays:
            return fn(*(_pad_to(x, s, self.device)
                        for x, s in zip(inputs, shapes)))
        key = (kind, shapes, self.compute_dtype, self.blend)
        g = self._graphs.get(key)
        if g is None or g.key is None:
            return self._capture(key, fn, inputs, shapes)
        self._graphs.move_to_end(key)
        for static, x in zip(g.inputs, inputs):
            _fill(static, x)
        g.graph.replay()
        decodes_replayed += 1
        graphs.add_counts(DECODE_COUNTERS, self._traffic(), g.counts)
        return g.outputs

    def _traffic(self) -> dict | None:
        return None if self.mesh is None else self.mesh.traffic

    def _capture(self, key: tuple, fn, inputs: tuple, shapes: tuple
                 ) -> tuple:
        """Run ``fn`` eagerly on new static inputs on a side stream, then
        capture it there into this ``Enhancer``'s memory pool
        (``utils.graphs.capture``) -> the eager run's outputs (the call
        that captures is that run; under a mesh it starts the NCCL
        communicators).  The capture launches and sends nothing: its LPS
        launches and collectives are kept for the replays and taken off
        the counters.  A capture that fails raises its error.  A graph
        captured under a mesh holds its collectives, so it is named to
        ``release_on_shutdown``."""
        global decode_graphs_captured
        with torch.cuda.device(self.device):
            statics = tuple(torch.empty(s, dtype=x.dtype, device=self.device)
                            for x, s in zip(inputs, shapes))
            for static, x in zip(statics, inputs):
                _fill(static, x)
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            while len(self._graphs) >= MAX_DECODE_GRAPHS:
                self._graphs.popitem(last=False)
            graph, outs, static_outs, counts = graphs.capture(
                lambda: fn(*statics), self._stream, pool=self._pool,
                counts=(DECODE_COUNTERS, self._traffic()))
            for out in outs:              # read on the current stream
                out.record_stream(torch.cuda.current_stream())
        if self._pool is None:
            self._pool = graph.pool()
        g = _DecodeGraph(key, graph, self._stream, statics, static_outs,
                         counts)
        self._graphs[key] = g
        if self.mesh is not None:
            release_on_shutdown(g)
        decode_graphs_captured += 1
        return outs

    def _core(self, frames: torch.Tensor, n_valid: torch.Tensor) -> tuple:
        return _decode_core(self.model, frames, self.mean, self.inv_std,
                            n_valid, self.basis, self.window,
                            self.frame_shift, self.context, self.blend,
                            self.compute_dtype, self.cast_weights)

    def _block_core(self, frames: torch.Tensor, n_valid: torch.Tensor
                    ) -> tuple:
        """``_core`` with the frame axis split over the data axis."""
        return _decode_core(self.model, frames, self.mean, self.inv_std,
                            n_valid, self.basis, self.window,
                            self.frame_shift, self.context, self.blend,
                            self.compute_dtype, self.cast_weights, self.mesh)

    def _waves_core(self, waves: torch.Tensor, n_valid: torch.Tensor
                    ) -> tuple[torch.Tensor]:
        """The int16 fast path's program: int16 waves [B, (T+1)*shift] ->
        (int16 enhanced waves [B, S],), framed on the device (frame_length
        == 2 * shift: each frame joins two adjacent shift-sized blocks)."""
        w = waves.to(torch.float32)
        blocks = w.reshape(w.shape[0], w.shape[1] // self.frame_shift,
                           self.frame_shift)
        frames = torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=2)
        return (trunc_int16(self._core(frames, n_valid)[0]),)

    def _lps_core(self, lps: torch.Tensor, n_valid: torch.Tensor
                  ) -> tuple[torch.Tensor]:
        """Noisy LPS [B, T, bins] -> (enhanced LPS,); under a mesh the
        frame axis is split over the data axis."""
        if self.mesh is None:
            return (_enhance_lps(self.model, lps, self.mean, self.inv_std,
                                 n_valid, self.context, self.blend,
                                 self.compute_dtype, self.cast_weights),)
        first, _, _, last = _frame_block(lps.shape[1], self.context,
                                         self.mesh)
        return (_enhance_split(self.model, lps[:, first:last], lps.shape[1],
                               self.mesh, self.mean, self.inv_std, n_valid,
                               self.context, self.blend, self.compute_dtype,
                               self.cast_weights),)

    def _staged_core(self, frames: torch.Tensor, n_valid: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The staged path's first program: frames [B, T, len] -> (noisy
        LPS, enhanced LPS), each [B, T, bins].  Under a mesh every rank
        computes the whole noisy LPS, and the network its block of it."""
        b, t, length = frames.shape
        lps = lps_from_frames(frames.reshape(b * t, length),
                              basis=self.basis).reshape(b, t, -1)
        return lps, self._lps_core(lps, n_valid)[0]

    def _synth_core(self, lps: torch.Tensor, frames: torch.Tensor,
                    n_valid: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
        """The staged path's second program: enhanced LPS [B, T, bins] and
        noisy frames [B, T, len] -> (OLA waveform [B, S], recon frames
        [B, T, len]); rows past ``n_valid`` add nothing."""
        valid = (torch.arange(frames.shape[1], device=frames.device)[None, :]
                 < n_valid[:, None])
        return _synth_and_ola(lps, frames, valid, self.frame_shift,
                              window=self.window)

    def _decode(self, frames: torch.Tensor, n_valid: torch.Tensor):
        """The fused decode: frames [B, T, len] and valid counts [B] (on
        the device or the host) -> (OLA waves [B, S], recon frames [B, T,
        len], enhanced LPS [B, T, bins]) for this B and T.  It runs at the
        padded shape (``_padded_shape``; one row stays one) and cuts the
        outputs back: on a card they are views of a replayed graph's static
        outputs, overwritten by this ``Enhancer``'s next decode.  Under a
        mesh one row's frames are split over the data axis, and several
        rows are (each data index decoding its block of rows)."""
        b, t, length = frames.shape
        b_pad, t_pad = self._padded_shape(b, t, batch=b > 1)
        if self.mesh is None:
            outs = self._run("frames", self._core, (frames, n_valid),
                             ((b_pad, t_pad, length), (b_pad,)))
        elif b == 1:
            outs = self._run("block", self._block_core, (frames, n_valid),
                             ((1, t_pad, length), (1,)))
        else:
            per = b_pad // self.mesh.data
            outs = self._run("rows", self._gathered(self._core),
                             self._my_rows(b_pad, frames, n_valid),
                             ((per, t_pad, length), (per,)))
        wave, recon, enh = outs
        cut = wave.shape[1] - (t_pad - t) * self.frame_shift
        return wave[:b, :cut], recon[:b, :t], enh[:b, :t]

    @torch.inference_mode()
    def enhance_lps(self, lps: np.ndarray) -> np.ndarray:
        """Enhanced (de-normalized) LPS [T, bins] from noisy LPS [T, bins],
        run at T padded to a multiple of ``DECODE_PAD_BUCKET`` (of the data
        axis too under a mesh, whose data indices split the frames)."""
        t, bins = lps.shape
        if t == 0:
            return np.zeros((0, bins), np.float32)
        (out,) = self._run(
            "lps", self._lps_core,
            (torch.from_numpy(np.ascontiguousarray(lps, np.float32))[None],
             torch.tensor([t])),
            ((1, self._padded_shape(1, t, batch=False)[1], bins), (1,)))
        return out[0, :t].cpu().numpy()

    @torch.inference_mode()
    def enhance(self, noisy_wave: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """noisy int16 wave -> (enhanced int16 wave, recon frames, enh LPS).

        Without smoothing or postprocessing the whole decode is one device
        program; with either, the staged path runs two (``_staged``), and
        them on the host between the forward pass and synthesis.
        """
        if not (self.smooth or self.postprocess):
            return self._decode_waves([noisy_wave], batch=False)[0]
        return self._staged(noisy_wave)

    def _staged(self, noisy_wave: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``enhance`` with smoothing or postprocessing, as ``tpu_se`` runs
        it: one program from the frames to the noisy and the enhanced LPS,
        the options in numpy on the host, then one program of the
        synthesis, both at the padded T; the synthesis' rows past the
        utterance are ``LOG_FLOOR`` LPS rows of zero frames, masked out
        (``tpu_se/dsp/synthesis.py:reconstruct``)."""
        frames = frame_signal(noisy_wave, self.frame_length,
                              self.frame_shift)
        t, length = frames.shape
        bins = length // 2 + 1
        if t == 0:
            return (np.zeros(length - self.frame_shift, np.int16),
                    np.zeros((0, length), np.float32),
                    np.zeros((0, bins), np.float32))
        t_pad = self._padded_shape(1, t, batch=False)[1]
        frames_t = torch.from_numpy(frames)[None]
        n_valid = torch.tensor([t])
        lps, enh = self._run("staged", self._staged_core,
                             (frames_t, n_valid),
                             ((1, t_pad, length), (1,)))
        lps, enh_lps = lps[0, :t].cpu().numpy(), enh[0, :t].cpu().numpy()
        if self.smooth:
            power = _exp_floored(enh_lps)
            s = (_smooth_auto_strength(lps)
                 if self.smooth_strength == "auto"
                 else self.smooth_strength)
            mixed = (1.0 - s) * power + s * smooth_power(power)
            enh_lps = np.log(mixed).astype(np.float32)
        if self.postprocess:
            enh_lps = postprocess_lps(enh_lps, lps)
        lps_p = np.full((1, t_pad, bins), LOG_FLOOR, np.float32)
        lps_p[0, :t] = enh_lps
        wave, recon = self._run("synth", self._synth_core,
                                (torch.from_numpy(lps_p), frames_t, n_valid),
                                ((1, t_pad, bins), (1, t_pad, length), (1,)))
        n = t * self.frame_shift + length - self.frame_shift
        return (np.trunc(wave[0, :n].cpu().numpy()).astype(np.int16),
                recon[0, :t].cpu().numpy(), enh_lps)

    @torch.inference_mode()
    def enhance_batch(self, waves: list
                      ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Enhance B utterances in one device pass, B and the longest
        utterance's frames padded to their buckets (``_padded_shape``).

        Matches per-utterance ``enhance`` within 1 int16 LSB (batched
        products may sum in another order).  Smoothing/postprocessing use
        the staged per-utterance path.
        """
        if self.smooth or self.postprocess:
            return [self.enhance(w) for w in waves]
        return self._decode_waves(waves, batch=True)

    def _empty(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (np.zeros(0, np.int16),
                np.zeros((0, self.frame_length), np.float32),
                np.zeros((0, self.frame_length // 2 + 1), np.float32))

    def _decode_waves(self, waves: list, batch: bool
                      ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The fused decode of B waves at their padded shape
        (``_padded_shape(B, longest, batch)``); an utterance too short for
        one frame gives empty outputs."""
        frames = [frame_signal(w, self.frame_length, self.frame_shift)
                  for w in waves]
        ts = [f.shape[0] for f in frames]
        empty = self._empty()
        if max(ts, default=0) == 0:
            return [empty for _ in waves]
        b_pad, t_pad = self._padded_shape(len(waves), max(ts), batch)
        frames_b = np.zeros((b_pad, t_pad, self.frame_length),
                            dtype=np.float32)
        for i, f in enumerate(frames):
            frames_b[i, : ts[i]] = f
        n_valid = np.zeros(b_pad, dtype=np.int64)
        n_valid[: len(ts)] = ts
        wave_b, recon_b, enh_b = self._decode(torch.from_numpy(frames_b),
                                              torch.from_numpy(n_valid))
        wave_b = wave_b.cpu().numpy()
        recon_b, enh_b = recon_b.cpu().numpy(), enh_b.cpu().numpy()
        tail = self.frame_length - self.frame_shift
        return [(np.trunc(wave_b[i, : t * self.frame_shift + tail]
                          ).astype(np.int16), recon_b[i, :t], enh_b[i, :t])
                if t else empty for i, t in enumerate(ts)]

    @torch.inference_mode()
    def decode_waves_tensor(self, waves: torch.Tensor,
                            n_valid: torch.Tensor) -> torch.Tensor:
        """Serving fast path on the device: int16 waves [B, (T+1)*shift] and
        frame counts [B] (on the device or the host) -> int16 enhanced
        waves [B, S] on the device, framed there.

        Framing uses frame_length == 2 * shift (the ETSI 50 %-overlap
        config, ``Wav2LogSpec_be.c:43,49``): each frame joins two adjacent
        shift-sized blocks.  The program runs at the padded shape
        (``_padded_shape``; without a mesh one row stays one, under a mesh
        B is padded to the batch bucket and each data index decodes its
        block of rows, the blocks all-gathered) and is replayed on a card,
        where the result is a view of the graph's static output,
        overwritten by this ``Enhancer``'s next decode.
        """
        b = waves.shape[0]
        shift = self.frame_shift
        t = waves.shape[1] // shift - 1
        b_pad, t_pad = self._padded_shape(
            b, t, batch=b > 1 or self.mesh is not None)
        if self.mesh is None:
            (wave,) = self._run("waves", self._waves_core, (waves, n_valid),
                                ((b_pad, (t_pad + 1) * shift), (b_pad,)))
        else:
            per = b_pad // self.mesh.data
            (wave,) = self._run("waves", self._gathered(self._waves_core),
                                self._my_rows(b_pad, waves, n_valid),
                                ((per, (t_pad + 1) * shift), (per,)))
        return wave[:b, : wave.shape[1] - (t_pad - t) * shift]

    def enhance_batch_waves(self, waves: list) -> list[np.ndarray]:
        """B int16 waves -> B enhanced int16 waves (serving fast path).

        int16-only host<->device traffic (``decode_waves_tensor``); waves
        equal ``enhance_batch``'s.  Needs frame_length == 2 * shift; the
        other configs and smoothing/postprocessing take the staged path.
        """
        shift = self.frame_shift
        if (self.smooth or self.postprocess
                or self.frame_length != 2 * shift):
            return [self.enhance(w)[0] for w in waves]
        ts = [max(0, (len(w) - shift) // shift) for w in waves]
        if max(ts, default=0) == 0:
            return [np.zeros(0, np.int16) for _ in waves]
        # enhance_batch's padded shape: the same program, the same bits.
        b_pad, t_pad = self._padded_shape(len(waves), max(ts), batch=True)
        waves_b = np.zeros((b_pad, (t_pad + 1) * shift), dtype=np.int16)
        for i, w in enumerate(waves):
            n = (ts[i] + 1) * shift if ts[i] else 0
            waves_b[i, :n] = np.asarray(w[:n], dtype=np.int16)
        n_valid = np.zeros(b_pad, dtype=np.int64)
        n_valid[: len(ts)] = ts
        wave_b = self.decode_waves_tensor(
            torch.from_numpy(waves_b),
            torch.from_numpy(n_valid)).cpu().numpy()
        tail = self.frame_length - shift
        return [wave_b[i, : t * shift + tail] if t
                else np.zeros(0, np.int16) for i, t in enumerate(ts)]


def enhance_utterance(wts_path, norm_path, noisy_wave: np.ndarray,
                      device="cuda", compute_dtype=torch.float32
                      ) -> np.ndarray:
    """One noisy int16 wave -> its enhanced int16 wave, on ``device``."""
    return Enhancer(wts_path, norm_path, device=device,
                    compute_dtype=compute_dtype).enhance(noisy_wave)[0]


def _quiet(line: str) -> None:
    pass


def _write_info(out_dir: str, stem: str, path: str, info: dict,
                noisy_info: bool) -> None:
    """``<stem>.info.txt`` as ``LPS2Wav_be`` writes it and, with
    ``noisy_info``, the noisy baseline's ``<input-filename>.info``."""
    with open(os.path.join(out_dir, stem + ".info.txt"), "w") as f:
        f.write("Segmental SNR:\n%f\n" % info["segsnr"])
        f.write("Log-Spectral Distortion:\n%f\n" % info["lsd"])
    if noisy_info:
        ni_name = os.path.basename(path) + ".info"
        with open(os.path.join(out_dir, ni_name), "w") as f:
            f.write("Segmental SNR:\n%f\n" % info["segsnr_noisy"])
            f.write("Log-Spectral Distortion:\n%f\n" % info["lsd_noisy"])


def decode_files(wts_path, norm_path, wav_paths: list, out_dir,
                 clean_paths: list | None = None, log=print,
                 noisy_info: bool = False, batch_size: int = 0,
                 postprocess: bool = False, smooth: bool = False,
                 smooth_strength=None, sample_rate: int = 16000,
                 blend=0.0, device="cuda", mesh=None) -> list[dict]:
    """decode.m batch loop: enhance each wav, write *_enhanced.wav + info.

    With ``clean_paths``, per-utterance SegSNR/LSD (enhanced and noisy
    baselines) go to ``<stem>.info.txt`` as ``LPS2Wav_be`` writes them;
    ``noisy_info`` also writes the noisy baseline to
    ``<input-filename>.info`` in ``out_dir`` (the ``-ni`` flag,
    ``LogSpec2Wav.c:843-861``).  ``batch_size`` > 1 decodes that many
    utterances per device pass (the int16 fast path when no metrics are
    needed); the default streams one utterance at a time.

    ``mesh``: every rank runs the loop (``Enhancer(mesh=)`` splits each
    utterance, or each batch, over the data axis) and returns the results;
    rank 0 alone writes the files and logs.
    """
    writer = mesh is None or mesh.rank == 0
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    else:
        log = _quiet
    enh = Enhancer(wts_path, norm_path, device=device,
                   postprocess=postprocess, smooth=smooth,
                   smooth_strength=smooth_strength,
                   sample_rate=sample_rate, blend=blend, mesh=mesh)
    norm_sr = 11000 if sample_rate == 11025 else sample_rate

    def check_rate(path, sr):
        if (11000 if sr == 11025 else sr) != norm_sr:
            raise ValueError(f"{path}: sample rate {sr} != decoder's "
                             f"{sample_rate} (pass sample_rate=)")

    waves_srs = outputs = None
    if batch_size > 1:
        waves_srs = [read_wav(p) for p in wav_paths]
        for (_, sr), p in zip(waves_srs, wav_paths):
            check_rate(p, sr)
        outputs = []
        for lo in range(0, len(waves_srs), batch_size):
            chunk = [w for w, _ in waves_srs[lo: lo + batch_size]]
            if clean_paths is None:
                outputs.extend((w, None, None)
                               for w in enh.enhance_batch_waves(chunk))
            else:
                outputs.extend(enh.enhance_batch(chunk))
    results = []
    for i, path in enumerate(wav_paths):
        noisy, sr = (waves_srs[i] if waves_srs is not None
                     else read_wav(path))
        check_rate(path, sr)
        wave, recon, enh_lps = (outputs[i] if outputs is not None
                                else enh.enhance(noisy))
        stem = os.path.splitext(os.path.basename(str(path)))[0]
        out_path = os.path.join(out_dir, stem + "_enhanced.wav")
        info = {"wav": str(path), "out": out_path}
        if writer:
            write_wav(out_path, wave, sr)
        if clean_paths is not None:
            clean, _ = read_wav(clean_paths[i])
            info.update(segsnr_lsd_pair(clean, noisy, recon,
                                        _exp_floored(enh_lps), sample_rate))
            if writer:
                _write_info(out_dir, stem, str(path), info, noisy_info)
            log(f"{stem}: segsnr={info['segsnr']:.2f} "
                f"(noisy {info['segsnr_noisy']:.2f}) "
                f"lsd={info['lsd']:.2f} (noisy {info['lsd_noisy']:.2f})")
        else:
            log(f"{stem}: enhanced -> {out_path}")
        results.append(info)
    return results
