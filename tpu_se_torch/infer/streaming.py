"""Streaming low-latency enhancement: hop in, hop out, with a fixed delay.

Port of ``tpu_se/infer/streaming.py``.  A stateful step takes one
``frame_shift``-sample hop per stream and emits one enhanced hop, equal to
the port's batch decode (``Enhancer.enhance``) within 1 int16 LSB: the same
framing preload (``Wav2LogSpec_be.c:401-416``), the same edge replication
as ``frame_expand.m``, the same OLA / summed-squared-window normalisation
as ``LogSpec2Wav.c:798-827``, at an algorithmic latency of

    half_context hops + one frame = 3*256 + 512 = 1280 samples = 80 ms
    at 16 kHz (the model's own lookahead; the engine adds none).

What differs from the JAX module, and why:

- The frame's log-power spectrum is the port's: ``lps_from_frames`` (the
  hand-written kernel at T = n_streams on a CUDA device, its plain version
  on the CPU), summed in float64 like the batch decode's.  Re and Im of
  the frame, which the noisy phase needs ``half`` hops later, come from
  ``torch.fft.rfft`` of the windowed frame and the synthesis from
  ``torch.fft.irfft``, exactly as ``dsp/synthesis.py`` takes them, so
  stream and batch scale the same spectrum.
- ``jax.jit`` and ``lax.scan`` become one captured CUDA graph per step.
  The state (sample ring, LPS and spectrum rings, OLA accumulators, the
  quality options' running statistics) lives in tensors that are allocated
  once; a step computes the new state and copies it back into them, so
  the captured graph can be replayed on every hop.  The host ships only
  the raw hop in and the enhanced hop out.  On the CPU, and on the card
  with ``graph=False``, the same step runs eagerly.
- ``n_streams`` independent channels are batched on the leading axis; no
  decision inside a step is taken on the host, so the streams may differ.
- Under a mesh (``mesh=``, one process per device) the channels split over
  the ``data`` axis, as the reference shards them: a rank holds the state
  of its ``n_streams / data`` channels and its own captured graphs at
  that size, steps its rows of every hop and all-gathers the outputs, so
  every rank returns the ``[S, ...]`` that one process returns.  The
  channels never interact: the gather is the only collective.  The
  network alone runs at all S rows on every rank (the rank's channels at
  their rows, zeros elsewhere): cuBLAS picks its kernel, and so a row's
  sum order, by the row count (a 2-row product differs from an 8-row one
  on an H100), and a channel's bits must not depend on the data axis'
  size.  The products cost one card's; the rest of a hop splits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_se_torch.dsp.analysis import (
    LOG_FLOOR, dft_basis, hamming_window, lps_from_frames, rate_config,
)
from tpu_se_torch.infer.decode import (
    _DB_PER_NEPER, BLEND_AUTO_LMAX, BLEND_AUTO_MAX, BLEND_AUTO_TAU_DB,
    NOISE_FRAME_NUM, SM_AUTO_D0, SM_AUTO_D1, SM_AUTO_S, _check_blend,
    _check_smooth_strength, trunc_int16,
)
from tpu_se_torch.io import read_norm, read_wts
from tpu_se_torch.models.ffn import FFN, params_from_numpy
from tpu_se_torch.ops.lps_kernel import POWER_FLOOR
from tpu_se_torch.utils import graphs
from tpu_se_torch.utils.device import resolve_compute_dtype, resolve_device


# Replays of a captured step graph, over every enhancer of the process.
# Each runs the LPS kernel once; ``lps_kernel.launches`` counts calls of
# ``lps_cuda``, so it sees a step's capture and not its replays.
hops_replayed = 0


class StreamState(NamedTuple):
    """Per-stream state on the device (leading axis = n_streams)."""

    ring: torch.Tensor        # [S, ring_hops*shift] newest input samples
    lps_ring: torch.Tensor    # [S, context, n_bins] normalized LPS, old first
    spec_ring: torch.Tensor   # [S, half+1, 2*n_bins] raw (Re|Im), old first
    acc: torch.Tensor         # [S, frame_length] OLA signal accumulator
    w2: torch.Tensor          # [S, frame_length] OLA squared-window sum
    hops: torch.Tensor        # [S] int32: input hops consumed
    count: torch.Tensor       # [S] int32: frames pushed into the rings
    supp_ema: torch.Tensor    # [S] running mean suppression (dB), blend=auto
    noise_max: torch.Tensor   # [S, n_bins] causal noise floor (smooth mode)
    sm_prev: torch.Tensor     # [S, n_bins] previous enhanced-frame power
    sm_prev_db: torch.Tensor  # [S] previous noisy mean-frame dB
    dyn_ema: torch.Tensor     # [S] EMA |delta frame dB| (impulsiveness gate)


class _Step(NamedTuple):
    """What a step needs besides the state: the model, the statistics and
    the analysis constants on the device, and the per-instance options."""

    model: FFN
    mean: torch.Tensor
    inv_std: torch.Tensor
    basis: torch.Tensor       # [frame_length, 2*n_bins] windowed-DFT basis
    window: torch.Tensor      # [frame_length] Hamming window
    frame_shift: int
    blend: object             # 0.0, a fraction in (0, 1), or "auto"
    smooth: object            # 0.0, a strength in (0, 1], or "auto"
    compute_dtype: torch.dtype   # of the network's product operands
    cast_weights: list | None    # model.cast_weights(compute_dtype), made
                                 # once: a hop never casts a weight
    rows: tuple | None = None    # under a data mesh (lo, S): this rank's
                                 # channels are rows lo.. of the S that the
                                 # network runs on (zeros elsewhere)


def _ring_hops(frame_length: int, frame_shift: int) -> int:
    return -(-frame_length // frame_shift)


def _mix_weights(alpha: float) -> tuple[float, float]:
    """(alpha, 1 - alpha) as the float32 pair the JAX step mixes two values
    with: the difference is taken in float32, not rounded from the double."""
    a = np.float32(alpha)
    return float(a), float(np.float32(1.0) - a)


# blend="auto" EMA coefficient: per-16ms-hop decay for a ~1 s time constant
# (exp(-0.016/1.0)); longer streams converge to the batch path's
# utterance-mean suppression for stationary noise.
_SUPP_EMA_ALPHA = 0.984

# smooth="auto" impulsiveness EMA: faster (~0.3 s) -- bursts reveal
# themselves quickly and the gate must close before they get smeared.
# dyn_ema starts at SM_AUTO_D1, so a stream STARTS with smoothing off (the
# conservative direction, like the blend EMA's maximal start) and ramps it
# in as the input proves quasi-stationary.
_DYN_EMA_ALPHA = 0.95


def _init_state(n_streams: int, frame_length: int, frame_shift: int,
                n_bins: int, context: int, device) -> StreamState:
    half = (context - 1) // 2

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return StreamState(
        ring=z(n_streams, _ring_hops(frame_length, frame_shift) * frame_shift),
        lps_ring=z(n_streams, context, n_bins),
        spec_ring=z(n_streams, half + 1, 2 * n_bins),
        acc=z(n_streams, frame_length),
        w2=z(n_streams, frame_length),
        hops=torch.zeros(n_streams, dtype=torch.int32, device=device),
        count=torch.zeros(n_streams, dtype=torch.int32, device=device),
        supp_ema=z(n_streams),
        noise_max=z(n_streams, n_bins),
        sm_prev=z(n_streams, n_bins),
        sm_prev_db=z(n_streams),
        dyn_ema=torch.full((n_streams,), SM_AUTO_D1, dtype=torch.float32,
                           device=device),
    )


def _enhance_and_emit(step: _Step, state: StreamState
                      ) -> tuple[StreamState, torch.Tensor]:
    """Shared back half of a step: splice -> forward -> synthesis -> OLA.

    The rings in ``state`` have already been advanced for this step.  The
    centre frame c = count-1-half is enhanced and overlap-added; the
    completed hop [c*shift, (c+1)*shift) is emitted (garbage while c < 0;
    the class discards those).  Every condition is a device mask: nothing
    here waits for the card, and the S streams may be at different points.

    ``blend`` limits the suppression depth (see ``infer/decode.py``): the
    centre frame's noisy LPS is recovered from the normalized ring
    (``normed / inv_std + mean``), so the streamed blend matches the batch
    decode's to float rounding.
    """
    s, context, n_bins = state.lps_ring.shape
    frame_length = state.acc.shape[1]
    shift = step.frame_shift
    half = (context - 1) // 2
    blend, smooth = step.blend, step.smooth

    x = state.lps_ring.reshape(s, context * n_bins)
    if step.rows is not None:
        # One process's row count: a row's sum order follows it (module
        # docstring).
        lo, rows = step.rows
        x = F.pad(x, (0, 0, lo, rows - lo - s))
    enh = step.model(x, compute_dtype=step.compute_dtype,
                     cast_weights=step.cast_weights)
    if step.rows is not None:
        enh = enh[lo:lo + s]
    enh = enh / step.inv_std + step.mean
    # The centre frame exists once count-1 >= half frames have been pushed.
    centre = state.count - 1 - half                           # [S] int32
    valid = centre >= 0
    if blend == "auto":
        # Streaming analog of the batch auto-blend: the per-utterance mean
        # suppression becomes a causal EMA over frames.  It starts at 0 dB,
        # i.e. the limiter starts at LMAX (most conservative) and relaxes
        # as the model shows confident suppression; it is frozen while the
        # centre frame does not exist.
        noisy_lps = state.lps_ring[:, half] / step.inv_std + step.mean
        supp_db = (noisy_lps - enh).mean(dim=1) * _DB_PER_NEPER
        a, one_minus_a = _mix_weights(_SUPP_EMA_ALPHA)
        ema = torch.where(valid, a * state.supp_ema + one_minus_a * supp_db,
                          state.supp_ema)
        state = state._replace(supp_ema=ema)
        lam = (BLEND_AUTO_LMAX
               * torch.exp(-ema.clamp(min=0.0) / BLEND_AUTO_TAU_DB)
               ).clamp(0.0, BLEND_AUTO_MAX)[:, None]
        enh = (1.0 - lam) * enh + lam * noisy_lps
    elif blend:
        noisy_lps = state.lps_ring[:, half] / step.inv_std + step.mean
        enh = (1.0 - blend) * enh + blend * noisy_lps

    cspec = torch.complex(state.spec_ring[:, 0, :n_bins],
                          state.spec_ring[:, 0, n_bins:])
    mag = cspec.abs()
    power = torch.where(enh < LOG_FLOOR, POWER_FLOOR, torch.exp(enh))
    if smooth:
        # Causal analog of the batch fractional smoother (decode.py
        # smooth_power + _smooth_auto_strength).  What causality forces: the
        # noise floor accumulates over the first NOISE_FRAME_NUM frames as
        # they arrive (the batch sees all 10 before it smooths frame 1);
        # the running-min window is {c-1, c} (a +1 lookahead would cost a
        # hop of latency); the impulsiveness gate is an EMA that starts
        # off (batch: a whole-utterance statistic).
        power_orig = power
        in_floor = (valid & (centre < NOISE_FRAME_NUM))[:, None]
        noise_max = torch.where(in_floor,
                                torch.maximum(state.noise_max, power),
                                state.noise_max)
        has_prev = (centre >= 1)[:, None]
        wmin = torch.minimum(torch.where(has_prev, state.sm_prev, power),
                             power)
        smoothed = torch.where(has_prev & (power < noise_max), wmin, power)
        if smooth == "auto":
            s_eff = SM_AUTO_S * ((SM_AUTO_D1 - state.dyn_ema)
                                 / (SM_AUTO_D1 - SM_AUTO_D0)
                                 ).clamp(0.0, 1.0)[:, None]
            power = (1.0 - s_eff) * power + s_eff * smoothed
        else:
            s_fixed, one_minus_s = _mix_weights(smooth)
            power = one_minus_s * power + s_fixed * smoothed
        state = state._replace(
            noise_max=noise_max,
            sm_prev=torch.where(valid[:, None], power_orig, state.sm_prev))
    scale = torch.where(mag > 0.0,
                        torch.sqrt(power) / torch.clamp(mag, min=1e-30), 0.0)
    synth = torch.fft.irfft(cspec * scale, n=frame_length, dim=-1)

    # Invalid frames contribute neither signal nor window weight (the batch
    # path's validity mask, dsp/synthesis.py).
    gate = valid.to(torch.float32)[:, None]
    acc = state.acc + synth * step.window * gate
    w2 = state.w2 + step.window * step.window * gate
    hop_out = acc[:, :shift] / torch.clamp(w2[:, :shift], min=1e-20)
    acc = F.pad(acc[:, shift:], (0, shift))
    w2 = F.pad(w2[:, shift:], (0, shift))
    return state._replace(acc=acc, w2=w2), hop_out


def _stream_step(step: _Step, state: StreamState, hop: torch.Tensor
                 ) -> tuple[StreamState, torch.Tensor]:
    """One hop [S, shift] in, one hop out, for all S streams."""
    shift = step.frame_shift
    ring = torch.cat([state.ring[:, shift:], hop], dim=1)
    s, context, n_bins = state.lps_ring.shape
    frame_length = state.acc.shape[1]
    # Frame f = hops+1-ring_hops starts at ring[0] once enough hops arrived
    # (the reference preloads len-shift samples, Wav2LogSpec_be.c:401-404).
    frame_ready = state.hops + 1 >= ring.shape[1] // shift        # [S] bool
    frame = ring[:, :frame_length]

    lps = lps_from_frames(frame, basis=step.basis)
    spec = torch.fft.rfft(frame * step.window, n=frame_length, dim=-1)
    normed = (lps - step.mean) * step.inv_std

    # The first frame replicates into the whole ring: the left-edge
    # clipping of the batch splice (frame_expand.m:7-10).
    ready = frame_ready[:, None, None]
    first = (state.count == 0)[:, None, None]
    lps_ring = torch.where(
        ready,
        torch.where(first, normed[:, None, :].expand(s, context, n_bins),
                    torch.cat([state.lps_ring[:, 1:], normed[:, None, :]],
                              dim=1)),
        state.lps_ring)
    reim = torch.cat([spec.real, spec.imag], dim=1)
    spec_ring = torch.where(
        ready, torch.cat([state.spec_ring[:, 1:], reim[:, None, :]], dim=1),
        state.spec_ring)

    if step.smooth == "auto":
        # Impulsiveness EMA from the NOISY input (blind, like the batch gate
        # statistic): |delta mean-frame-dB| between consecutive frames.
        frame_db = lps.mean(dim=1) * _DB_PER_NEPER
        have_prev = frame_ready & (state.count >= 1)
        d = (frame_db - state.sm_prev_db).abs()
        a, one_minus_a = _mix_weights(_DYN_EMA_ALPHA)
        state = state._replace(
            dyn_ema=torch.where(have_prev,
                                a * state.dyn_ema + one_minus_a * d,
                                state.dyn_ema),
            sm_prev_db=torch.where(frame_ready, frame_db, state.sm_prev_db))
    state = state._replace(
        ring=ring, lps_ring=lps_ring, spec_ring=spec_ring,
        hops=state.hops + 1,
        count=state.count + frame_ready.to(torch.int32))
    return _enhance_and_emit(step, state)


def _flush_step(step: _Step, state: StreamState
                ) -> tuple[StreamState, torch.Tensor]:
    """Drain one latency hop: push the newest LPS and spectrum rows again
    (right-edge replication, ``frame_expand.m:19-22``) without input."""
    state = state._replace(
        lps_ring=torch.cat([state.lps_ring[:, 1:], state.lps_ring[:, -1:]],
                           dim=1),
        spec_ring=torch.cat([state.spec_ring[:, 1:], state.spec_ring[:, -1:]],
                            dim=1),
        count=state.count + 1)
    return _enhance_and_emit(step, state)


class StreamingEnhancer:
    """Stateful real-time enhancer over ``n_streams`` concurrent channels.

    Single-stream use (sample chunks of any size, buffered here)::

        s = StreamingEnhancer(wts, norm)
        out = [s.feed(chunk) for chunk in chunks]   # int16 pieces
        out.append(s.flush())
        enhanced = np.concatenate(out)              # == batch Enhancer

    Multi-stream serving: call :meth:`push` with aligned [S, shift] hops
    (or :meth:`push_many` with [S, K, shift] chunks: one transfer each way
    per chunk); warm outputs start after ``warmup_hops`` pushes.

    Quality options stream through causal analogs: ``blend="auto"`` uses a
    ~1 s suppression EMA; ``smooth_strength`` (fixed or ``"auto"``) a
    causal noise floor and a {c-1, c} min window, with an impulsiveness
    EMA that starts with smoothing off.

    ``device`` is ``"cuda"`` (default; raises without a card) or ``"cpu"``.
    On a CUDA device the step and the flush step are each captured once in
    a CUDA graph and replayed per hop; a capture that fails raises.
    ``graph=False`` runs the same step eagerly on the card: the reference
    that the replayed step is held against, bit for bit.
    The module's ``hops_replayed`` counts the replays of step graphs.
    ``compute_dtype`` (``torch.float32``, ``torch.bfloat16`` or their names)
    is the type of the network's product operands; the reduced copy of the
    frozen weights is made once, here, and the captured step reads it.
    ``mesh`` (a ``tpu_se_torch.parallel.Mesh``; every rank makes the same
    calls): the channels split over its data axis (see the module's
    docstring), on the mesh's device; ``n_streams`` must divide by the
    data axis' size.
    """

    SCAN_HOPS = 8  # hops per chunk that feed() sends through push_many()

    def __init__(self, wts_path, norm_path, n_streams: int = 1,
                 context: int = 7, sample_rate: int = 16000, blend=0.0,
                 smooth_strength=None, device="cuda", graph: bool = True,
                 compute_dtype=torch.float32, mesh=None):
        data = 1 if mesh is None else mesh.data
        if n_streams % data:
            raise ValueError(f"n_streams {n_streams} not divisible by mesh "
                             f"data axis {data}")
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.blend = _check_blend(blend)
        # As the batch Enhancer resolves it: a non-zero strength turns the
        # (causal) smoother on by itself; None/0 = off.
        self.smooth = _check_smooth_strength(smooth_strength)
        model = params_from_numpy(read_wts(wts_path), self.device)
        dim = model.biases[-1].shape[0]
        (self.frame_length, self.frame_shift,
         fft_length) = rate_config(sample_rate)
        self.n_bins = fft_length // 2 + 1
        if self.n_bins != dim:
            raise ValueError(f"model dim {dim} != {self.n_bins} bins "
                             f"at {sample_rate} Hz")
        mean, inv_std = read_norm(norm_path, dim)
        # This rank's channels: all of them without a mesh.
        local = n_streams // data
        lo = 0 if mesh is None else mesh.data_rank * local
        self._step_args = _Step(
            model=model,
            mean=torch.from_numpy(mean).to(self.device),
            inv_std=torch.from_numpy(inv_std).to(self.device),
            basis=dft_basis(self.frame_length, self.device),
            window=torch.from_numpy(
                hamming_window(self.frame_length)).to(self.device),
            frame_shift=self.frame_shift, blend=self.blend,
            smooth=self.smooth, compute_dtype=self.compute_dtype,
            cast_weights=(None if self.compute_dtype == torch.float32
                          else model.cast_weights(self.compute_dtype)),
            rows=None if data == 1 else (lo, n_streams))
        self.context = context
        self.half = (context - 1) // 2
        self.ring_hops = _ring_hops(self.frame_length, self.frame_shift)
        self.n_streams = n_streams
        self._mine = slice(lo, lo + local)
        # Allocated once: the step writes into these, never rebinds them.
        self.state = _init_state(local, self.frame_length,
                                 self.frame_shift, self.n_bins, context,
                                 self.device)
        hop_shape = (local, self.frame_shift)
        self._hop = torch.zeros(hop_shape, device=self.device)
        self._out = torch.zeros(hop_shape, device=self.device)
        self._out_i16 = torch.zeros(hop_shape, dtype=torch.int16,
                                    device=self.device)
        self._step_graph = self._flush_graph = None
        if self.device.type == "cuda" and graph:
            self._step_graph = self._capture(self._step)
            self._flush_graph = self._capture(self._flush)
        self.reset()

    @torch.inference_mode()
    def reset(self) -> None:
        """Back to the start of a stream, in the same tensors (and so under
        the same captured graphs): every channel forgets its input."""
        fresh = _init_state(self._hop.shape[0], self.frame_length,
                            self.frame_shift, self.n_bins, self.context,
                            self.device)
        for dst, src in zip(self.state, fresh):
            dst.copy_(src)
        self._pushed = 0          # frames pushed into the rings (real+flush)
        self._hops = 0            # input hops consumed
        self._pending = np.zeros((0,), dtype=np.float32)

    def _commit(self, new: StreamState, out: torch.Tensor) -> None:
        """Write a step's results into the tensors that outlive it.  The
        int16 hop is cast here, on the device: through int32, since a
        float -> int16 cast out of range is undefined on the GPU."""
        for dst, src in zip(self.state, new):
            dst.copy_(src)
        self._out.copy_(out)
        self._out_i16.copy_(trunc_int16(out))

    def _step(self) -> None:
        self._commit(*_stream_step(self._step_args, self.state, self._hop))

    def _flush(self) -> None:
        self._commit(*_flush_step(self._step_args, self.state))

    @torch.inference_mode()
    def _capture(self, fn) -> torch.cuda.CUDAGraph:
        """Warm ``fn`` up on a side stream (it builds the kernel library and
        the FFT plans, which a capture cannot), then capture it there
        (``utils.graphs.capture``)."""
        with torch.cuda.device(self.device):
            return graphs.capture(fn, torch.cuda.Stream())[0]

    def _run_step(self) -> None:
        global hops_replayed
        if self._step_graph is None:
            self._step()
        else:
            self._step_graph.replay()
            hops_replayed += 1

    def _host(self, tensor: torch.Tensor) -> np.ndarray:
        """All channels' rows of ``tensor`` (all-gathered over the data
        axis under a mesh) as a host copy that the next step will not
        overwrite."""
        if self.mesh is not None:
            tensor = self.mesh.all_gather(tensor, 0, "data")
        if tensor.device.type == "cpu":
            return tensor.numpy().copy()
        return tensor.cpu().numpy()

    def _emitting(self) -> bool:
        # The emitted hop is frame c = pushed-1-half; valid once c >= 0.
        return self._pushed - 1 - self.half >= 0

    @property
    def latency_samples(self) -> int:
        """Algorithmic input->output delay in samples."""
        return self.half * self.frame_shift + self.frame_length

    @property
    def warmup_hops(self) -> int:
        """push() calls before the first valid output hop."""
        return self.ring_hops - 1 + self.half + 1

    @torch.inference_mode()
    def push(self, hops: np.ndarray) -> np.ndarray | None:
        """[S, shift] float32 hops -> [S, shift] float32 enhanced hop, or
        ``None`` during the first ``warmup_hops - 1`` calls."""
        hops = np.asarray(hops, dtype=np.float32)
        if hops.shape != (self.n_streams, self.frame_shift):
            raise ValueError(f"push wants hops of shape "
                             f"{(self.n_streams, self.frame_shift)}, got "
                             f"{hops.shape}")
        self._hop.copy_(torch.from_numpy(
            np.ascontiguousarray(hops[self._mine])))
        self._run_step()
        self._hops += 1
        if self._hops >= self.ring_hops:
            self._pushed += 1
        return self._host(self._out) if self._emitting() else None

    @torch.inference_mode()
    def push_many(self, hops: np.ndarray, int16_wire: bool = False
                  ) -> tuple[np.ndarray, np.ndarray]:
        """[S, K, shift] hops -> ([S, K, shift] enhanced hops, [K] bool
        validity mask), with one transfer each way for the chunk.

        Sample for sample what K :meth:`push` calls give: the same step
        runs K times, on slices of the uploaded chunk.

        ``int16_wire``: ship int16 both ways (PCM audio is int16-valued
        anyway), half the bytes per chunk; the enhanced hops come back
        int16, the truncated values of the float32 wire's.
        """
        hops = np.asarray(hops, dtype=np.int16 if int16_wire else np.float32)
        if (hops.ndim != 3 or (hops.shape[0], hops.shape[2])
                != (self.n_streams, self.frame_shift)):
            raise ValueError(f"push_many wants [{self.n_streams}, K, "
                             f"{self.frame_shift}] hops, got {hops.shape}")
        k = hops.shape[1]
        h0 = self._hops
        chunk = torch.from_numpy(
            np.ascontiguousarray(hops[self._mine])).to(self.device)
        outs = torch.empty_like(chunk)
        emitted = self._out_i16 if int16_wire else self._out
        for j in range(k):
            self._hop.copy_(chunk[:, j])         # int16 -> float32 is exact
            self._run_step()
            outs[:, j].copy_(emitted)
        self._hops += k
        self._pushed += (max(0, self._hops - (self.ring_hops - 1))
                         - max(0, h0 - (self.ring_hops - 1)))
        valid = np.arange(h0, h0 + k) >= self.warmup_hops - 1
        return self._host(outs), valid

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Single-stream: int16/float samples of any length in, all the
        enhanced int16 samples that are ready out."""
        if self.n_streams != 1:
            raise ValueError("feed() is single-stream; use push()")
        buf = np.concatenate(
            [self._pending, np.asarray(samples, dtype=np.float32)])
        shift = self.frame_shift
        pieces = []
        n_hops = len(buf) // shift
        i = 0
        # The int16 wire wraps values outside [-32768, 32767]: only true
        # 16-bit PCM (integer-valued AND in range) rides it.
        int_input = buf.size == 0 or (
            float(np.sum(buf != np.trunc(buf))) == 0.0
            and float(np.abs(buf).max()) < 32768.0)
        # Full SCAN_HOPS groups go through push_many (one transfer each way
        # per group), stragglers through push.
        while n_hops - i >= self.SCAN_HOPS:
            chunk = buf[i * shift:(i + self.SCAN_HOPS) * shift]
            outs, valid = self.push_many(
                chunk.reshape(1, self.SCAN_HOPS, shift),
                int16_wire=int_input)
            pieces.extend(outs[0, j] for j in range(self.SCAN_HOPS)
                          if valid[j])
            i += self.SCAN_HOPS
        for h in range(i, n_hops):
            out = self.push(buf[h * shift:(h + 1) * shift][None, :])
            if out is not None:
                pieces.append(out[0])
        self._pending = buf[n_hops * shift:]
        if not pieces:
            return np.zeros((0,), dtype=np.int16)
        return np.trunc(np.concatenate(pieces)).astype(np.int16)

    def flush(self) -> np.ndarray:
        """Drain the latency pipeline (single-stream).

        Trailing samples short of a full hop form one more frame only when
        they reach the frame boundary the batch framer uses (``num_frames``,
        dsp/analysis.py): at 16 kHz (len = 2*shift) never, at 11 kHz (len =
        2.33*shift) when >= len - (ring_hops-1)*shift samples remain.  That
        last hop is zero-padded (the zeros fall outside the frame);
        anything shorter is dropped, as the batch framer drops it."""
        if self.n_streams != 1:
            raise ValueError("flush() is single-stream; use flush_hops()")
        pieces = []
        need = self.frame_length - (self.ring_hops - 1) * self.frame_shift
        if len(self._pending) >= need:
            pad = np.zeros(self.frame_shift - len(self._pending),
                           dtype=np.float32)
            out = self.push(np.concatenate([self._pending, pad])[None, :])
            if out is not None:
                pieces.append(np.trunc(out[0]).astype(np.int16))
        self._pending = np.zeros((0,), dtype=np.float32)
        pieces.extend(np.trunc(out[0]).astype(np.int16)
                      for out in self.flush_hops())
        ntail = self.frame_length - self.frame_shift
        tail = (self._host(self.state.acc)[:, :ntail]
                / np.maximum(self._host(self.state.w2)[:, :ntail], 1e-20))
        pieces.append(np.trunc(tail[0]).astype(np.int16))
        return np.concatenate(pieces)

    @torch.inference_mode()
    def flush_hops(self):
        """Yield the drain hops [S, shift] (multi-stream flush): ``half``
        steps of right-edge replication, skipping those still warming."""
        for _ in range(self.half):
            if self._flush_graph is None:
                self._flush()
            else:
                self._flush_graph.replay()
            self._pushed += 1
            if self._emitting():
                yield self._host(self._out)
