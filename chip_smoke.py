#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_se_torch``) on one GPU or more.

    python3 chip_smoke.py

Needs one CUDA card (its cross-card phase runs on two or four), ``nvcc``
and the repository checkout; it imports nothing of JAX.  In order, and
failing (non-zero exit) at the first fault:

1. reports torch/CUDA versions and the card's name and power limit;
2. requires ``torch.cuda.is_available()``;
3. builds the CUDA kernels from ``tpu_se_torch/csrc`` (timed);
4. kernel phase: counts the ``DMMA`` (fp64 tensor-core) instructions of
   each LPS kernel in the built library's SASS (``cuobjdump -sass``) and
   fails on 0; ``lps_cuda`` against ``lps_plain`` on the card, for T in
   {1, 8, 37, 128, 256, 4097} (1, 8 and 128 are the streaming step's),
   both sides of the kernel's tile switch and the decode's own shapes,
   L in {512, 256}, seeded frames x1000 with zeroed
   rows (which must give exactly -50); atol 1e-5 in the log domain, and a
   rerun must be bitwise equal; times both, with the kernel's fp64
   TFLOP/s, at T in {1, 8, 128, 256, 992, 3968, 4096, 16384} and the
   batched decode's shape, by events and, beside the kernel's bound and
   an empty kernel's launch, by device time (CUDA-graph replay);
5. slice phase: writes a full-width (1799, 2048, 2048, 2048, 257) random
   model, four 16 kHz noisy/clean wav pairs and their ``.norm``, then runs
   ``python -m tpu_se_torch decode`` in-process on the card (plain,
   ``--batch 4``, ``--blend auto --smooth-strength auto``, all with
   ``--clean-scp``, and ``--batch 4`` without it: the int16 fast path),
   counting kernel launches; checks lengths, finite SegSNR/LSD, and waves
   within 1 int16 LSB of the same decode with ``--device cpu``; times the
   device-only batched decode;
6. GGD kernel phase: ``ggd_output_grad_cuda`` against
   ``ggd_output_grad_plain`` on the card for M in {1, 7, 128, 1000, 4096,
   16384} and both sides of each switch of the launcher's plan, D in
   {257, 129, 5}, beta in {0.5, 0.9, 1, 2}, on seeded inputs with rows
   where out == targ and one column equal throughout (exactly 0 in dedx,
   alpha exactly 0 there); rtol 5e-6 on alpha and dedx; a rerun must be
   bitwise equal, and so must beta = 1 (no ``powf``) and the general path
   at beta = 1; times both at M = 128 and 4096, D = 257, by events and by
   device time (CUDA-graph replay), beside the byte bound and an empty
   kernel launched the same way;
7. optimizer kernel phase: ``sgd_update_cuda`` against
   ``sgd_update_plain`` on the card, bit for bit (params and velocity):
   first that the card's ``g / n`` by a host scalar is ``g *
   float32(1/n)`` at n = 3 and 100 (the kernel's rounding rests on it);
   then the full-width model's 12,605,697 parameters at n in {1, 3, 100,
   128}, weight cost 0 and 1e-5, the rate as a float and as a 0-dim
   tensor, with -0.0 steps and an inf weight in the last bias; views at
   1, 2 and 3 floats into one flat buffer (every tensor unaligned); one
   captured CUDA graph replayed at two rates; a list longer than one
   table (two launches); device time of the full-width update by
   CUDA-graph replay beside the byte bound (20 bytes per parameter at
   3.35 TB/s), the plain ops' and an empty kernel launched the same way,
   with the card's name and power limit;
8. training phase: writes a 24-sentence synthetic LPS pfile pair and a
   full-width initial ``.wts`` (``python -m tpu_se_torch gen-rand-net``),
   runs ``python -m tpu_se_torch train --epochs 2`` in-process on the card
   with the defaults (parity, M = 128, ML-GGD, beta = 1, lrate 0.1),
   checks its outputs and that the GGD kernel launched once per ML bunch
   (and the optimizer kernel once per GGD launch, on every one-device
   card run here and below), and that a second card run writes a
   byte-identical ``mlp.2.wts``; ``train --dropoutflag 1`` twice (masks
   drawn inside the replayed bunches; the rerun byte-identical, the
   weights not the maskless run's); then runs the same command at
   ``--lrate 0.001`` on the card and on
   ``--device cpu`` and holds their weight changes to each other (per
   layer, relative difference <= 1e-3) and their CV metrics to rtol 1e-4;
   times one epoch's training; every one-device training run on the card
   here and below replays a captured bunch: its replays must be its
   bunches less one eager warm-up bunch per capture.  (At the default
   lrate the full-width
   training is chaotic: any float32 rounding difference grows ~30x every 4
   bunches, and two CPU implementations differ by 5-9 % after one epoch, so
   only a smaller step can hold two devices to each other.)  Then the
   train-graph phase: ``train_chunk`` with its captured bunch replayed
   (``graph=True``) and eager (``graph=False``) from the same full-width
   state over one chunk of seeded resident frames, M = 128 float32 (400
   bunches) and M = 4096 bfloat16 (50 bunches), at lrate 0.1: weights,
   velocity and alpha bitwise equal, one GGD launch per bunch, replays =
   bunches - 1; a fresh replayed chunk with the optimizer kernel bitwise
   equal to one with the plain update (``train.step.sgd_momentum_update``
   replaced by ``sgd_update_plain``); ms per bunch of both (host clock,
   then in turns), device busy us and launches per bunch (``torch.profiler``), the first call's
   ms (a warm-up bunch and the capture) and a call's with new frames (a
   capture again; the memory this adds) against an eager bunch's, beside
   the card's name and power limit; with dropout masks (0.1, 0.1), M =
   128 float32 and M = 4096 bfloat16, two chunks with a generator each,
   replayed against eager (bitwise, the generators' offsets equal after
   each chunk, one capture, replays = bunches - 1, the weights not those
   of the chunks without masks, ms per bunch in turns); one NCCL rank (a
   1x1 group in the child) replayed against its eager mesh loop at each
   chunk and at M = 128 with masks (in a child process, so that its
   traces of training bunches stay out of this one);
9. pipeline phase: the paper's whole pipeline through the CLI, in-process,
   at full width, from a 24-sentence 16 kHz noisy/clean wav corpus:
   ``lps-extract --device cuda --jobs 4`` over the 48 wavs (one LPS kernel
   launch per file, counted), held against ``--device cpu`` on a copy
   (identical HTK headers, data within atol 1e-5); ``make-pfile`` with
   ``--lenfile`` (noisy) and ``--deslenfile`` (clean), ``get-norm``,
   ``concat-pfile``, ``pfile-info --sents``, ``gen-rand-net`` and
   ``wts-info``, with their counts checked; two chained ``bptrain`` epochs
   on ``device=cuda`` from the ``finetune.pl`` strings (the GGD kernel
   launched once per ML bunch, three finite CV lines in each log, no
   ``.state.npz``), and ``train --epochs 2`` on the card from the same
   init and seed, whose ``mlp.1.wts`` and ``mlp.2.wts`` must be
   byte-identical to the chain's; ``decode --device cuda`` of the 4 CV
   sentences with the chain's weights and the ``get-norm`` statistics
   (its enhanced LPS within atol 1e-3 of the CPU's), and ``eval --json``
   of clean against enhanced (all four metrics finite); the same decode
   and ``eval`` with the training phase's ``--lrate 0.001`` weights, a
   model that stays inside int16 (waves within 1 LSB of the CPU's, SegSNR
   above the overflowing model's -20.0);
   prints the phase's wall time and ``lps-extract``'s time per file, with
   the analysis basis uploaded per file and kept on the card;
10. streaming phase, at the slice phase's full-width model and its four
   utterances: ``decode --stream 4096 --device cuda`` through the CLI
   (one captured CUDA graph replayed per hop; replays counted, one LPS
   kernel launch in each), its waves within 1 int16 LSB of the card's
   batch decode of the same files and of ``--stream 4096 --device cpu``;
   8 streams through ``push_many`` (K = 8, int16 wire) with ``blend`` and
   ``smooth_strength`` ``"auto"``, replayed against the same step run
   eagerly on the card (outputs and final state bitwise equal) and
   against the CPU (within 1 LSB); the device launches of one eager and
   one replayed hop from ``torch.profiler`` (exactly one LPS kernel in
   each) and where the hop's device time goes; per hop at 1, 8 and 128
   streams: eager and replayed device time by CUDA events, the replayed
   hop's profile, wall p50/p99 over 300 ``push`` calls, ``push_many``
   hops/s with the float and the int16 wire, and the channels of
   real-time audio that is (a hop is 16 ms at 16 kHz);
11. bfloat16 phase (``compute_dtype=bfloat16``: bfloat16 operands, float32
   sums, everything else float32), at the same full-width model and
   fixtures; nothing falls back to float32 or to the CPU:
   ``FFN`` on the card against the CPU's formulation (widened operands)
   for M in {1, 8, 128, 992, 4096}, with and without
   ``act_dtype=bfloat16``: every layer on the CPU's own input within 1e-5
   of the output's scale (only the float32 sums' order differs), the whole
   network within 0.75 of the float32 network's distance (a float32 sum
   order can round a hidden activation to the neighbouring bfloat16 value,
   after which the later layers' rounding noise is drawn anew), and one
   linear layer alone, forward and the two backward products; the device
   kernels of a bfloat16 batch decode from ``torch.profiler`` (no float32
   SGEMM among the network's products); ``Enhancer(compute_dtype=
   torch.bfloat16)`` at batch 4 and 16: enhanced LPS against the CPU's
   bfloat16 decode, one LPS kernel launch per batch, and ms per batch
   beside the float32 decode's over 5 repeats; ``StreamingEnhancer(
   compute_dtype=torch.bfloat16)`` at 1, 8 and 128 streams: 64 hops
   replayed against eager on the card (bitwise), launches per hop, the
   network's share and the replayed step's time beside float32's;
   ``train --compute-dtype bfloat16 --epochs 2`` on the card twice
   (byte-identical), at ``--lrate 0.001`` on the card and on the CPU
   (weight changes per layer and CV metrics within the bfloat16
   tolerances), one ``bptrain compute_dtype=bfloat16`` epoch byte-identical
   to ``train``'s first, the GGD kernel launched once per ML bunch,
   samples/s at M = 128 and ms per bunch at M = 4096 beside float32's;
   ``wav_to_mfcc`` on the card against the CPU; one training bunch under
   ``profile_trace``, whose Chrome trace must hold CUDA kernels, one of
   them the GGD kernel (in one of three traces: the tracer now and then
   loses a window's device records);
12. data-parallel phase, at the training phase's full-width fixtures; the
   ranks are child processes of ``python -m tpu_se_torch train`` (and of
   ``python -m tpu_se_torch.bench.dp_epoch`` for the timings), each
   cluster under its own time limit; a child's unexpected exit code, a
   timeout or a failed comparison ends the smoke with the children's
   output: the split GGD kernels (``ggd_colsum_cuda`` +
   ``ggd_grad_from_sums_cuda``) against their plain versions for M in
   {64, 128, 1024, 4096}, D = 257, beta in {1, 0.9, 2} (rtol 5e-6, exact
   zeros, bitwise reruns), fed their own sums bit for bit the fused
   kernel, two half-bunches' sums added against the whole bunch's alpha,
   and their device times beside their byte bounds and an empty launch;
   one rank over NCCL (``--coordinator ... --num-processes 1``), a 1x1
   mesh whose model is a ``TensorParallelFFN``, whose
   ``mlp.2.wts`` must be byte-identical to the training phase's
   single-process run, with two split launches and two all-reduces per ML
   bunch counted; two ranks sharing the card over gloo
   (``--cpu-collectives gloo``) at ``--lrate 0.001``: weight changes within
   1e-3 of the one-process card run, a second run byte-identical, the
   ranks' own end-of-epoch replica check, only rank 0's files on disk, and
   (in ``dp_epoch``) the all-gathered resident span equal to the unsharded
   one; one rank over NCCL with ``--dropoutflag 1``: its bunches
   replayed but a warm-up per capture, ``mlp.2.wts`` byte-identical to the
   one-process dropout run; the refusals (``--mesh-data 2`` and ``--mesh-model 2`` on one
   card, ``--mesh-model 3`` at a hidden width of 2048, NCCL with two ranks
   on one card); ms per bunch for one rank fused, one rank over NCCL and
   two ranks over gloo, with the bytes each collective moves;
13. tensor-parallel phase, at the same fixtures, ranks as child processes
   of ``python -m tpu_se_torch train --mesh-model 2`` sharing the card over
   gloo at ``--lrate 0.001``: a 1 x 2 and a 2 x 2 mesh, each twice; each
   held to the one-process card run (weight changes within 1e-3), its
   rerun byte-identical, only rank 0's files on disk, the ranks' replica
   and shard checks, two split GGD launches per ML bunch and rank, and the
   collectives of each axis counted against the layout's (per bunch: the
   data axis' two all-reduces; the model axis' two all-reduces and one
   all-gather; per CV batch one of each; the checkpoint's gathers); ms per
   bunch of both through ``bench/dp_epoch --mesh-model 2``;
14. decoder-mesh phase: ``bench/mesh_decode`` as two ranks sharing the
   card over gloo -- ``Enhancer(mesh=)`` (``enhance`` plain and with
   ``blend="auto"``, ``enhance_batch``, ``enhance_batch_waves``) of the
   slice phase's four utterances and ``StreamingEnhancer(mesh=)`` of 8
   streams x 16 hops on the int16 wire -- against the same calls in one
   process on the card: every rank's outputs equal, waves within 1 int16
   LSB (bitwise by form reported), enhanced LPS within rtol 1e-5, atol
   1e-5, each rank's LPS launches equal to the one process's and 16 graph
   replays;
15. cross-card phase: the mesh paths over NCCL, one rank per card, as far
   as the machine's cards go (one line names each run left out and the
   cards it needs; nothing runs in its place); each card's name and power
   limit; the children of every other phase see card 0 alone, as on a
   one-card machine.  With two cards or more: ``train --mesh-data 1
   --mesh-model 2`` at ``--lrate 0.001`` twice in float32 and once in
   bfloat16; with four, ``--mesh-data 2 --mesh-model 2`` and
   ``--mesh-data 1 --mesh-model 4``, each twice; clusters on disjoint
   cards run together.  Each rank's closing ``data mesh:`` line holds the
   layout's collectives per axis (calls and bytes: the model axis' two
   all-reduces and one all-gather per bunch, per CV batch one of each, the
   checkpoint's gathers; the data axis' two all-reduces per bunch at data
   2) and replicas equal at every epoch end; only rank 0's files; weight
   changes and CV metrics within the float32 bars (1e-3, 1e-4) or the
   bfloat16 ones (5e-2, 1e-3) of the one-process card run of the same
   products; each float32 shape's rerun byte-identical.  ms per global
   bunch through ``bench/dp_epoch`` as it is, one cluster at a time: one
   process, 2x1 and 1x2 (two cards), 4x1, 2x2 and 1x4 (four), with each
   axis' collectives per bunch.  ``bench/mesh_decode`` at 2 and 4 data
   ranks against the one-process card decode at the decoder-mesh phase's
   bars, the int16 streams bitwise; frames/s of ``enhance_batch_waves``
   over 16 utterances in one process and at each rank count (host clock);
   with four cards, the overlapped step at 4x1 (``overlap_mesh_runs``):
   every rank's replayed bunches bit for bit its eager loop's, launches
   and collectives equal, ms per global bunch beside the replayed flat
   step's in turns, and every rank's replayed window traced (the µs NCCL
   kernels run beside GEMM kernels); the launches of these runs join the
   kernel table;
16. host chunk loader phase (run after the training phase, at its
   fixtures): compiles ``tpu_se_torch/csrc/chunk_loader.cc`` with the host
   compiler (timed) and loads the library; reads, byte-swaps and
   normalises the training span (noisy + clean) through the library and
   through numpy, 5 times each (MB/s, median), the rows bit for bit
   equal; trains 2 epochs per chunk (``device_resident="never"``) with
   rows by each route, whose ``mlp.2.wts`` must be byte-identical (and is
   compared with the resident run's); epoch samples/s per chunk by both
   routes beside the resident epoch's;
17. overlapped-step phase (after the data-parallel phase):
   ``train_chunk_overlap`` replayed and eager and ``train_chunk`` replayed
   at ``mesh=None`` on the card, three epochs each from the same weights
   (the replayed overlapped state bitwise its eager loop's and the flat
   step's, or the smoke fails; one fused GGD launch per bunch; ms per
   bunch of the three in turns); the same three states on one NCCL rank
   in float32 and bfloat16 (``overlap_mesh_runs``: replayed bitwise
   eager, launches and collectives equal, a traced replayed window of
   each step); then, through
   ``bench/dp_epoch.py --lrate 0.001 --out``, one process (flat step,
   float32 and bfloat16) as the reference, and one rank over NCCL and two
   ranks sharing the card over gloo, flat and ``--overlap``, one cluster
   at a time (ms per bunch), each within 1e-3 of the reference's weight
   changes, with one all-reduce per layer and bunch plus the column sums'
   and two split GGD launches per bunch and rank; both overlapped forms
   again, byte-identical; the bfloat16 ring on two gloo ranks and on one
   NCCL rank (within the bfloat16 bar of the bfloat16 reference); every
   NCCL rank's bunches replayed, flat and overlapped; the first timed
   runs trace 8 bunches (``dp_epoch --profile``): over gloo (eager) the
   backward products issued while each bunch's rings are in flight (two
   per hidden layer overlapped, none flat), over NCCL a replayed window
   (``check_replayed_profile``); the us by which NCCL kernels overlap
   GEMM kernels on the device, and where the host's time goes (the host
   ops of most self time per bunch);
18. examples phase (last): ``tpu_se_torch.examples.serve_streaming`` on
   the slice phase's longest utterance with its model (graph replays = hops
   and two eager LPS calls per enhancer; the single stream as long as the
   batch decode), and ``tpu_se_torch.examples.demo_pipeline`` at full
   width, 40 epochs, on a synthetic 14-condition stand-in of the demo
   corpus (``bench/fixtures.py:write_demo_corpus``): finite SegSNR, LSD
   and STOI for the held-out condition, one LPS launch per wav and one GGD
   launch per ML bunch, its 40 ``.wts`` deleted after;
19. benches phase: each measurement module (``tpu_se_torch/bench/``
   ``train`` in float32 and bfloat16, ``decode``, ``stream``, ``loader``,
   ``build``, ``scaling`` at one rank) once at short settings
   (``BENCH_RUNS``), each module's ``main`` in turn in one child process:
   each exits 0 and prints its record, the same as its ``--out`` file,
   headed by its metric, on this card, with every one of its own checks
   held; its kernel launches join the table;
20. prints the kernel table as JSON (each kernel's launches summed over
   every path that ran it; its device time, its plain version's and its
   bound at the main path's shape), the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from tpu_se_torch.bench import dp_epoch  # noqa: E402
from tpu_se_torch.bench.fixtures import (  # noqa: E402
    DEMO_CONDITIONS, SAMPLE_RATE, SEED, SHIFT, card_line, device_us,
    pad_batch, stream_hops, time_ms, write_corpus_fixtures,
    write_demo_corpus, write_fixtures, write_train_fixtures,
)
from tpu_se_torch.bench.profile_decode import device_profile  # noqa: E402
from tpu_se_torch.cli.main import main as cli_main  # noqa: E402
from tpu_se_torch.data import PfilePairDataset, plan_chunks  # noqa: E402
from tpu_se_torch.dsp import analysis  # noqa: E402
from tpu_se_torch.dsp.analysis import dft_basis, wav_to_mfcc  # noqa: E402
from tpu_se_torch.examples import (  # noqa: E402
    demo_pipeline, serve_streaming,
)
from tpu_se_torch.infer import Enhancer, StreamingEnhancer  # noqa: E402
from tpu_se_torch.infer import streaming  # noqa: E402
from tpu_se_torch.io import (  # noqa: E402
    native, read_norm, read_pfile_meta, read_wav, read_wts, write_wav,
)
from tpu_se_torch.models import init_params, params_from_numpy  # noqa: E402
from tpu_se_torch.models.ffn import (  # noqa: E402
    DEFAULT_LAYERSIZES, reduced_linear, reduced_product,
)
from tpu_se_torch.ops import (  # noqa: E402
    _build, ggd_kernel, lps_kernel, sgd_kernel,
)
from tpu_se_torch.ops.sgd_kernel import (  # noqa: E402
    sgd_update_cuda, sgd_update_plain,
)
from tpu_se_torch.ops._build import (  # noqa: E402
    load_library, sass_opcode_counts,
)
from tpu_se_torch.bench.mesh_decode import decode_all  # noqa: E402
from tpu_se_torch.parallel import (  # noqa: E402
    MeshConfig, initialize_distributed, make_mesh, param_shardings,
    shutdown_distributed, sync_processes,
)
from tpu_se_torch.parallel.mesh import free_port  # noqa: E402
from tpu_se_torch.parallel.overlap_step import (  # noqa: E402
    train_chunk_overlap,
)
from tpu_se_torch.train import (  # noqa: E402
    CV_BATCH, TrainConfig, TrainHyper, load_checkpoint, load_device_frames,
    make_train_state, run_training, train_chunk,
    train_one_epoch,
)
from tpu_se_torch.train import loop as loop_mod  # noqa: E402
from tpu_se_torch.train import step as step_mod  # noqa: E402
from tpu_se_torch.utils import profile_trace  # noqa: E402

# Kernel against plain, log domain.  Both sum in float64 and round only
# re/im to float32, so they agree to a few float32 ulps of the log power
# (1 ulp = 1.9e-6 for |log power| in [16, 32)); a float32 sum in the
# kernel would miss by ~1e-3 at these shapes and fail this limit.
LPS_ATOL = 1e-5
# Kernel against plain, float32 both: a few ulps, from the sum order and
# powf against torch.pow (the CPU check of plain against JAX saw 6.4e-7).
GGD_RTOL = 5e-6
GGD_BETAS = (0.5, 0.9, 1.0, 2.0)
# The optimizer kernel phase: bunch sizes n (the natural scale, two whose
# g / n rounds, the parity scale), weight costs, offsets in floats of views
# into one flat buffer, and the recipe's rate and momentum.
SGD_NS = (1, 3, 100, 128)
SGD_WCS = (0.0, 1e-5)
SGD_OFFSETS = (1, 2, 3)
SGD_LR = 0.1
SGD_MOMENTUM = 0.9
# The data-parallel phase: the split kernels' rows (a rank's share of a
# bunch at 2 ranks and at 1, and two larger bunches) and shape factors, and
# the seconds a cluster of child ranks may take before it is killed.
SPLIT_ROWS = (64, 128, 1024, 4096)
SPLIT_BETAS = (1.0, 0.9, 2.0)
RANKS_TIMEOUT_S = 300
# The tensor-parallel phase: a model axis of 2, and data axes of 1 and 2.
TP_MODEL = 2
TP_DATA = (1, 2)
# The decoder-mesh phase: streams and hops through StreamingEnhancer(mesh=).
MESH_STREAMS = 8
MESH_HOPS = 16
# The host chunk loader phase: reads of the training span per route.
NATIVE_READS = 5
# The examples phase: seconds per utterance of the demo corpus stand-in
# (its TIMIT sentences run 2-4 s).
DEMO_SECONDS = 3.0
# The card's published peaks (NVIDIA H100 SXM at 700 W) that the kernels'
# bounds are stated against: device memory, and fp64 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP64_TENSOR_FLOPS = 67e12
# Card against CPU training, 2 epochs at AGREE_LRATE: relative difference
# of the weight CHANGES per layer and of the CV metrics.  At the default
# lrate 0.1 the full-width ML-GGD run is chaotic (the 257 outputs sum 2048
# hidden units, so one step moves them by more than the error scale and
# the sign(e) gradient flips); at 0.001 float32 differences stay ~1e-5.
TRAIN_DW_RTOL = 1e-3
TRAIN_CV_RTOL = 1e-4
# Card against CPU decode of the pipeline's trained model, enhanced LPS in
# the log domain: the FFN's float32 sums in another order move an output of
# ~27 by a few ulps (1.9e-6 each) per layer.
DECODE_LPS_ATOL = 1e-3
AGREE_LRATE = "0.001"
# bfloat16 (compute_dtype=bfloat16), card against CPU.  Both round the same
# operands to bfloat16 and sum exact products in float32; the two sum
# orders differ by float32 ulps, which can round a hidden activation (or a
# weight of the next bunch) to the neighbouring bfloat16 value.
# - One product: sum order only, relative to the result's scale.
BF16_PRODUCT_RTOL = 1e-5
# - A result that is itself rounded to bfloat16 (dW, dh): one flipped
#   rounding, one bfloat16 ulp.
BF16_ULP = 2.0 ** -7
# - The whole network, the enhanced LPS: one flipped hidden activation
#   (a step of 2^-8) moves the next layer's 2048 inputs by ~1e-4, which
#   flips ~1 % of THEIR roundings, and so on: after a first flip the rest
#   of the network's rounding noise is drawn anew.  Two bfloat16
#   evaluations are therefore as far apart as part of bfloat16's own
#   rounding noise, which the run measures as the float32 network's
#   distance; they share the first layers' noise, so they must stay within
#   this share of it (a float32 fallback would sit at 1.0, a rounded z
#   beyond).  The tight check is layer by layer on the same input.
BF16_NET_SHARE = 0.75
# - Two epochs at AGREE_LRATE: weight changes per layer and CV metrics.
#   Flipped weight roundings (2^-9 relative each, a few per cent of the
#   weights per bunch once the runs are float32 ulps apart) put the two
#   runs' gradients ~2^-9/sqrt(n) apart; the first layer's gradient sums
#   to far less than its terms, which the CPU tests saw cost 2 %.
BF16_TRAIN_DW_RTOL = 5e-2
BF16_TRAIN_CV_RTOL = 1e-3
MFCC_ATOL = 1e-3          # the CPU tests' bound against JAX; here ~1e-5
BF16_ROWS = (1, 8, 128, 992, 4096)
BIG_BUNCH = 4096
BUNCH = 128
# The train-graph phase: (M, products' dtype, bunches in its chunk), on
# GRAPH_FRAMES resident seeded frames at lrate GRAPH_LRATE (the recipe's);
# GRAPH_PROFILED bunches under torch.profiler per step form.
GRAPH_CHUNKS = ((BUNCH, "float32", 400), (BIG_BUNCH, "bfloat16", 50))
GRAPH_FRAMES = 32768
GRAPH_LRATE = 0.1
GRAPH_PROFILED = 8
GRAPH_RECAPTURES = 5
# Dropout in the train-graph phase: the reference's (visible_omit,
# hid_omit) defaults (finetune.pl:75-76); (M, products' dtype, bunches per
# chunk), each trained as two chunks with a generator each, seeded from
# GRAPH_MASK_SEEDS, as train_one_epoch makes one per chunk.
GRAPH_DROPOUT = (0.1, 0.1)
DROPOUT_CHUNKS = ((BUNCH, "float32", 100), (BIG_BUNCH, "bfloat16", 20))
GRAPH_MASK_SEEDS = (7, 8)
TRACE_WINDOWS = 3         # traces of one bunch before a lost record fails
EPOCHS = 2
# name -> (with --clean-scp, extra decode flags)
RUNS = {
    "plain": (True, []),
    "batch4": (True, ["--batch", "4"]),
    "quality": (True, ["--blend", "auto", "--smooth-strength", "auto"]),
    "batch4_waves": (False, ["--batch", "4"]),     # int16 fast path
}
# The streaming phase: the CLI's chunk, the stream counts timed, the hops
# per push_many chunk, and how many push calls the wall percentiles take.
STREAM_CHUNK = 4096
STREAM_COUNTS = (1, 8, 128)
CHUNK_HOPS = 8
PUSH_CALLS = 300
# The finetune.pl chain: epoch 1's init_randem_seed, and the step it adds
# for each later epoch (finetune.pl:86,124).
FINETUNE_SEED = 27870775
SEED_STEP = 345


def tensor_core_check() -> None:
    """The LPS kernels must compute on the fp64 tensor cores: count DMMA
    instructions in each of their functions in the built library."""
    counts = {name: n for name, n in sass_opcode_counts("DMMA").items()
              if "lps_kernel" in name}
    for name, n in counts.items():
        print(f"sass    {n:4d} DMMA in {name}")
    if not counts or min(counts.values()) == 0:
        raise SystemExit(f"LPS kernel without DMMA instructions: {counts}")


def kernel_phase(dev, decode_rows: list[int]) -> dict:
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    switch = [lps_kernel.SMALL_TILE_MAX_T, lps_kernel.SMALL_TILE_MAX_T + 1]
    for length in (512, 256):
        basis = dft_basis(length, dev)
        shapes = sorted({*STREAM_COUNTS, 37, 256, 4097, *switch,
                         *(decode_rows if length == 512 else [])})
        for t in shapes:
            frames = (rng.standard_normal((t, length)) * 1000).astype(
                np.float32)
            frames[3::7] = 0.0                       # floor rows
            x = torch.from_numpy(frames).to(dev)
            got = lps_kernel.lps_cuda(x, basis)
            again = lps_kernel.lps_cuda(x, basis)
            torch.cuda.synchronize()
            want = lps_kernel.lps_plain(x, basis)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            floor_ok = bool((got[3::7] == -50.0).all().item()) if t > 3 else True
            same = torch.equal(got, again)
            print(f"kernel  L={length} T={t:5d}: max|cuda-plain|={err:.3e} "
                  f"floor rows exact={floor_ok} rerun bitwise={same}")
            if not (err <= LPS_ATOL and floor_ok and same
                    and bool(torch.isfinite(got).all().item())):
                raise SystemExit(f"lps_cuda disagrees at L={length} T={t}")
            max_err = max(max_err, err)
        zeros = torch.zeros((64, length), device=dev)
        if not bool((lps_kernel.lps_cuda(zeros, basis) == -50.0).all()):
            raise SystemExit(f"all-zero block is not -50 at L={length}")
        torch.cuda.synchronize()

    basis = dft_basis(512, dev)
    lib, _ = load_library()
    empty_us = device_us(lambda: lib.ggd_launch_floor(
        BUNCH, 257, torch.cuda.current_stream().cuda_stream))
    print(f"kernel  an empty kernel launched the same way: device time "
          f"{empty_us:.2f} us (what a launch costs the card, whatever T)")
    times = {}
    for t in sorted({*STREAM_COUNTS, 256, 992, 3968, 4096, 16384,
                     decode_rows[-1]}):
        x = torch.from_numpy((rng.standard_normal((t, 512)) * 1000).astype(
            np.float32)).to(dev)
        cuda_ms = time_ms(lambda: lps_kernel.lps_cuda(x, basis))
        plain_ms = time_ms(lambda: lps_kernel.lps_plain(x, basis))
        tflops = 2 * t * 512 * 514 / (cuda_ms * 1e-3) / 1e12
        print(f"kernel  T={t:5d} L=512: lps_cuda {cuda_ms * 1e3:.1f} "
              f"us/call ({tflops:.1f} TFLOP/s fp64), lps_plain "
              f"{plain_ms * 1e3:.1f} us/call")
        dev_ms = device_us(lambda: lps_kernel.lps_cuda(x, basis)) / 1e3
        dev_plain_ms = device_us(lambda: lps_kernel.lps_plain(x, basis)) / 1e3
        bound_ms, bound_by = lps_bound_ms(t, 512, 257)
        times[t] = {"ms": dev_ms, "plain_ms": dev_plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"kernel  T={t:5d} L=512: device time lps_cuda "
              f"{dev_ms * 1e3:.2f} us, lps_plain {dev_plain_ms * 1e3:.2f} us; "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}), "
              f"{bound_ms / dev_ms:.0%} of it reached")
    return {"max_abs_err": max_err, "times": times}


def lps_bound_ms(t: int, length: int, n_bins: int) -> tuple[float, str]:
    """The least the card could take for [t, length] frames: the larger of
    the product's 2 * t * length * 2 * n_bins fp64 operations at the tensor
    cores' peak and of frames + basis read, LPS written, at the memory
    rate."""
    ops_ms = 2 * t * length * 2 * n_bins / FP64_TENSOR_FLOPS * 1e3
    moved = 4 * (t * length + length * 2 * n_bins + t * n_bins)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def run_decode(fx: dict, out_dir: str, device: str, clean: bool,
               extra: list) -> None:
    argv = ["decode", "--scp", fx["scp"], "--wts", fx["wts"],
            "--norm", fx["norm"], "--out-dir", out_dir, "--device", device,
            *(["--clean-scp", fx["cscp"]] if clean else []), *extra]
    rc = cli_main(argv)
    if rc != 0:
        raise SystemExit(f"decode {argv} returned {rc}")


def wrapped_lsb(a: np.ndarray, b: np.ndarray) -> int:
    """Largest |a - b| in int16 steps, modulo the 16-bit wrap both sides share."""
    d = (a.astype(np.int64) - b.astype(np.int64) + 32768) % 65536 - 32768
    return int(np.abs(d).max()) if d.size else 0


def read_info(path: str) -> tuple[float, float]:
    lines = open(path).read().split("\n")
    return float(lines[1]), float(lines[3])


def slice_phase(root: str, fx: dict) -> int:
    stems = [os.path.splitext(os.path.basename(p))[0]
             for p in open(fx["scp"]).read().split()]
    lps_kernel.launches = 0
    for name, (clean, extra) in RUNS.items():
        run_decode(fx, os.path.join(root, name, "cuda"), "cuda", clean, extra)
    torch.cuda.synchronize()
    launches = lps_kernel.launches
    print(f"slice   lps_kernel.launches over the decode runs: {launches}")
    if launches <= 0:
        raise SystemExit("the decode path never launched lps_cuda")

    for name, (clean, extra) in RUNS.items():
        run_decode(fx, os.path.join(root, name, "cpu"), "cpu", clean, extra)
        worst = 0
        for stem, wave in zip(stems, fx["waves"]):
            got, _ = read_wav(os.path.join(root, name, "cuda",
                                           stem + "_enhanced.wav"))
            ref, _ = read_wav(os.path.join(root, name, "cpu",
                                           stem + "_enhanced.wav"))
            t = len(wave) // SHIFT - 1
            if len(got) != t * SHIFT + SHIFT or len(ref) != len(got):
                raise SystemExit(f"{name}/{stem}: {len(got)} samples, "
                                 f"expected {t * SHIFT + SHIFT}")
            worst = max(worst, wrapped_lsb(got, ref))
            if clean:
                seg, lsd = read_info(os.path.join(root, name, "cuda",
                                                  stem + ".info.txt"))
                seg_c, lsd_c = read_info(os.path.join(root, name, "cpu",
                                                      stem + ".info.txt"))
                if not (np.isfinite(seg) and np.isfinite(lsd)):
                    raise SystemExit(f"{name}/{stem}: SegSNR/LSD not finite")
                if abs(seg - seg_c) > 1e-3 or abs(lsd - lsd_c) > 1e-3:
                    raise SystemExit(f"{name}/{stem}: info differs from CPU "
                                     f"({seg}, {lsd}) vs ({seg_c}, {lsd_c})")
        print(f"slice   {name:12s}: {len(stems)} utterances, max "
              f"|cuda-cpu| = {worst} LSB")
        if worst > 1:
            raise SystemExit(f"{name}: CUDA decode differs from CPU by "
                             f"{worst} LSB")
    return launches


def decode_fps(dev, fx: dict, repeats: int = 5) -> float:
    """Device-only frames/s of the batched int16 decode (4 utterances):
    CUDA events over 20 back-to-back batches, median of ``repeats``."""
    enh = Enhancer(fx["wts"], fx["norm"], device=dev)
    x, n_valid, frames = pad_batch(fx["waves"], dev)
    runs = [time_ms(lambda: enh.decode_waves_tensor(x, n_valid), iters=20)
            for _ in range(repeats)]
    ms = sorted(runs)[repeats // 2]
    fps = frames / (ms / 1e3)
    print(f"slice   device-only batched decode: "
          f"{', '.join(f'{r:.4f}' for r in runs)} ms per batch of "
          f"{len(fx['waves'])} ({frames} frames); median {ms:.4f} ms = "
          f"{fps:.0f} frames/s")
    return fps


def ggd_inputs(rng, m: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded (out, targ) [m, d]: every 5th row and column d // 2 have
    out == targ."""
    out = rng.standard_normal((m, d)).astype(np.float32)
    targ = (out + rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    targ[2::5] = out[2::5]
    targ[:, d // 2] = out[:, d // 2]
    return out, targ


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / |want| over want != 0; inf if got != 0 where
    want == 0."""
    nz = want != 0
    if bool((got[~nz] != 0).any()):
        return float("inf")
    if not bool(nz.any()):
        return 0.0
    return ((got - want).abs()[nz] / want.abs()[nz]).max().item()


def ggd_bound_ms(m: int, d: int) -> float:
    """The least the card could take for an [m, d] bunch: out and targ read
    once, dedx and alpha written once, at the memory rate (the arithmetic,
    a few operations per element, is far below it)."""
    return 4 * (3 * m * d + d) / HBM_BYTES_PER_S * 1e3


def ggd_phase(dev) -> dict:
    rng = np.random.default_rng(SEED)
    lib, _ = load_library()
    worst = 0.0
    max_abs = 0.0
    switch = [m for last in ggd_kernel.PLAN_SWITCH_ROWS
              for m in (last, last + 1)]
    for m in sorted({1, 7, 128, 1000, 4096, 16384, *switch}):
        plan = ggd_kernel.plan(m, 257)
        for d in (257, 129, 5):
            out_np, targ_np = ggd_inputs(rng, m, d)
            out = torch.from_numpy(out_np).to(dev)
            targ = torch.from_numpy(targ_np).to(dev)
            errs = []
            for beta in GGD_BETAS:
                dedx, alpha = ggd_kernel.ggd_output_grad_cuda(out, targ, beta)
                dedx2, alpha2 = ggd_kernel.ggd_output_grad_cuda(out, targ,
                                                                beta)
                want_d, want_a = ggd_kernel.ggd_output_grad_plain(out, targ,
                                                                  beta)
                torch.cuda.synchronize()
                rel = max(max_rel(dedx, want_d), max_rel(alpha, want_a))
                zeros = (bool((dedx[2::5] == 0).all())
                         and bool((dedx[:, d // 2] == 0).all())
                         and alpha[d // 2].item() == 0.0)
                same = (torch.equal(dedx, dedx2)
                        and torch.equal(alpha, alpha2))
                finite = bool(torch.isfinite(dedx).all()
                              and torch.isfinite(alpha).all())
                if not (rel <= GGD_RTOL and zeros and same and finite):
                    raise SystemExit(
                        f"ggd_output_grad_cuda disagrees at M={m} D={d} "
                        f"beta={beta}: max rel {rel:.3e}, exact zeros "
                        f"{zeros}, rerun bitwise {same}, finite {finite}")
                errs.append(rel)
                worst = max(worst, rel)
                max_abs = max(max_abs,
                              (dedx - want_d).abs().max().item(),
                              (alpha - want_a).abs().max().item())
            # beta = 1 skips powf; the general path takes it: same bits.
            dedx, alpha = ggd_kernel.ggd_output_grad_cuda(out, targ, 1.0)
            gen_d, gen_a = ggd_kernel.ggd_output_grad_cuda(out, targ, 1.0,
                                                           general=True)
            torch.cuda.synchronize()
            if not (torch.equal(dedx, gen_d) and torch.equal(alpha, gen_a)):
                differ = int((dedx != gen_d).sum() + (alpha != gen_a).sum())
                raise SystemExit(
                    f"beta=1 shortcut differs from the general path at M={m} "
                    f"D={d}: {differ} values, max |diff| "
                    f"{(dedx - gen_d).abs().max().item():.3e}")
            print(f"ggd     M={m:5d} D={d:3d}: max rel |cuda-plain| over "
                  f"beta {GGD_BETAS} = "
                  f"{', '.join(f'{e:.2e}' for e in errs)}; zeros exact, "
                  f"rerun bitwise equal, beta=1 shortcut bitwise equal to "
                  f"the general path; plan: strips of {plan.cols} columns x "
                  f"{plan.cluster} blocks of {plan.rows_per_block} rows, "
                  f"{plan.threads} threads, keep={plan.keep}")
    times = {}
    for m in (128, 4096):
        out_np, targ_np = ggd_inputs(rng, m, 257)
        out = torch.from_numpy(out_np).to(dev)
        targ = torch.from_numpy(targ_np).to(dev)

        def kernel():
            return ggd_kernel.ggd_output_grad_cuda(out, targ, 1.0)

        def plain():
            return ggd_kernel.ggd_output_grad_plain(out, targ, 1.0)

        def empty():
            lib.ggd_launch_floor(m, 257,
                                 torch.cuda.current_stream().cuda_stream)

        cuda_ms, plain_ms = time_ms(kernel), time_ms(plain)
        dev_ms, dev_plain_ms = device_us(kernel) / 1e3, device_us(plain) / 1e3
        floor_us = device_us(empty)
        bound_ms = ggd_bound_ms(m, 257)
        times[m] = {"ms": dev_ms, "plain_ms": dev_plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes"}
        print(f"ggd     M={m:5d} D=257 beta=1: ggd_output_grad_cuda "
              f"{cuda_ms * 1e3:.1f} us/call, ggd_output_grad_plain "
              f"{plain_ms * 1e3:.1f} us/call")
        print(f"ggd     M={m:5d} D=257 beta=1: device time "
              f"ggd_output_grad_cuda {dev_ms * 1e3:.2f} us, "
              f"ggd_output_grad_plain {dev_plain_ms * 1e3:.2f} us, an empty "
              f"kernel launched the same way {floor_us:.2f} us; bound "
              f"{bound_ms * 1e3:.2f} us (bytes), {bound_ms / dev_ms:.0%} of "
              f"it reached")
    return {"max_rel_err": worst, "max_abs_err": max_abs, "times": times}


def sgd_lists(base: list, dev, offset: int | None = None) -> list:
    """``base``'s numpy (params, velocity, grads) as tensors on the card;
    with ``offset``, each list's tensors are views into one flat buffer
    that start ``offset`` floats in, as ``Mesh.all_reduce_sum_flat``
    returns them."""
    if offset is None:
        return [[{k: torch.from_numpy(a).to(dev) for k, a in layer.items()}
                 for layer in x] for x in base]
    out = []
    for x in base:
        flat = torch.empty(offset + sum(a.size for layer in x
                                        for a in layer.values()),
                           device=dev)
        lo, views = offset, []
        for layer in x:
            views.append({})
            for k, a in layer.items():
                views[-1][k] = flat[lo:lo + a.size].view(a.shape)
                views[-1][k].copy_(torch.from_numpy(a))
                lo += a.size
        out.append(views)
    return out


def sgd_base(rng, layersizes) -> list:
    """Seeded numpy (params, velocity, grads) ``[{"w", "b"}]``; the last
    bias has -0.0 gradients and velocities and an inf weight, where a
    decay of 0 * p would change bits."""
    base = [[{"w": rng.standard_normal((a, b)).astype(np.float32),
              "b": rng.standard_normal(b).astype(np.float32)}
             for a, b in zip(layersizes[:-1], layersizes[1:])]
            for _ in range(3)]
    base[1][-1]["b"][:8] = -0.0
    base[2][-1]["b"][:8] = -0.0
    base[0][-1]["b"][8] = np.inf
    return base


def sgd_diff(got: list, want: list) -> tuple[bool, float]:
    """(bitwise equal, max |got - want| where they differ) over params and
    velocity."""
    same, worst = True, 0.0
    for x, y in zip(got[:2], want[:2]):
        for lx, ly in zip(x, y):
            for k in ("w", "b"):
                a, b = lx[k], ly[k]
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    same = False
                    worst = max(worst, float(torch.where(
                        a == b, 0.0, (a - b).abs()).nan_to_num(
                            nan=float("inf")).max()))
    return same, worst


def sgd_bound_ms(lists: list) -> float:
    """The least the card could take for an update of ``lists``: p, v and
    g read once and p and v written once, at the memory rate (five float
    operations per element are far below it)."""
    n = sum(t.numel() for layer in lists[0] for t in layer.values())
    return 20 * n / HBM_BYTES_PER_S * 1e3


def sgd_phase(dev) -> dict:
    """The optimizer kernel against the plain update on the card, bit for
    bit: the division premise; full width at every n of ``SGD_NS``, weight
    cost and form of the rate; views at unaligned offsets; a captured graph
    at two rates; a list longer than one table.  Device time by CUDA-graph
    replay beside the byte bound, the plain ops' and an empty launch's.
    Launches made here are not the main path's: the count is restored."""
    counted = sgd_kernel.launches
    rng = np.random.default_rng(SEED)
    g = torch.from_numpy(rng.standard_normal(1 << 20).astype(
        np.float32)).to(dev)
    for n in SGD_NS[1:3]:
        inv = float(np.float32(1) / np.float32(n))
        if not torch.equal((g / n).view(torch.int32),
                           (g * inv).view(torch.int32)):
            raise SystemExit(f"on this card g / {n} is not g * float32(1/{n})"
                             ": the kernel's division premise fails")
    print(f"sgd     g / n on the card equals g * float32(1/n) bitwise at n "
          f"in {SGD_NS[1:3]} (PyTorch's division by a host scalar)")
    base = sgd_base(rng, DEFAULT_LAYERSIZES)
    worst = 0.0

    def check(label: str, got: list, want: list) -> None:
        nonlocal worst
        torch.cuda.synchronize()
        same, diff = sgd_diff(got, want)
        if not same:
            raise SystemExit(f"sgd_update_cuda differs from the plain update "
                             f"({label}): max |diff| {diff:.3e}")
        worst = max(worst, diff)

    cases = 0
    for n in SGD_NS:
        for wc in SGD_WCS:
            for tensor_lr in (False, True):
                got, want = sgd_lists(base, dev), sgd_lists(base, dev)
                lr = (torch.tensor(SGD_LR, dtype=torch.float32, device=dev)
                      if tensor_lr else SGD_LR)
                before = sgd_kernel.launches
                sgd_update_cuda(*got, lr, SGD_MOMENTUM, wc, n)
                sgd_update_plain(*want, lr, SGD_MOMENTUM, wc, n)
                if sgd_kernel.launches - before != 1:
                    raise SystemExit("sgd_update_cuda: not one launch")
                check(f"n={n} wc={wc} tensor lr={tensor_lr}", got, want)
                cases += 1
    narrow = sgd_base(rng, (1799, 63, 257))
    for offset in SGD_OFFSETS:
        got, want = sgd_lists(narrow, dev, offset), sgd_lists(narrow, dev)
        sgd_update_cuda(*got, SGD_LR, SGD_MOMENTUM, 1e-5, BUNCH)
        sgd_update_plain(*want, SGD_LR, SGD_MOMENTUM, 1e-5, BUNCH)
        check(f"views {offset} floats into one buffer", got, want)
    got, want = sgd_lists(base, dev), sgd_lists(base, dev)
    rate = torch.full((), SGD_LR, dtype=torch.float32, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sgd_update_cuda(*got, rate, SGD_MOMENTUM, 1e-5, BUNCH)
    for lr in (SGD_LR, 0.05, 0.05):
        rate.fill_(lr)
        graph.replay()
        sgd_update_plain(*want, lr, SGD_MOMENTUM, 1e-5, BUNCH)
    check("a captured graph replayed at two rates", got, want)
    del graph
    long_sizes = tuple(range(3, 4 + sgd_kernel.MAX_TENSORS))
    many = sgd_base(rng, long_sizes)
    got, want = sgd_lists(many, dev), sgd_lists(many, dev)
    before = sgd_kernel.launches
    sgd_update_cuda(*got, SGD_LR, SGD_MOMENTUM, 1e-5, 1)
    sgd_update_plain(*want, SGD_LR, SGD_MOMENTUM, 1e-5, 1)
    tables = sgd_kernel.launches - before
    check(f"{2 * (len(long_sizes) - 1)} tensors", got, want)
    if tables != 2:
        raise SystemExit(f"sgd_update_cuda: {tables} launches for "
                         f"{2 * (len(long_sizes) - 1)} tensors")
    n_params = sum(a.size for layer in base[0] for a in layer.values())
    print(f"sgd     sgd_update_cuda bitwise equal to sgd_update_plain on the "
          f"card: full width ({n_params:,} parameters) at n in {SGD_NS}, "
          f"weight cost in {SGD_WCS}, lr as a float and as a 0-dim tensor ({cases} "
          f"cases, -0.0 steps and an inf weight included); views "
          f"{SGD_OFFSETS} floats into one buffer at (1799, 63, 257); a "
          f"captured graph replayed at lr {SGD_LR} and 0.05; "
          f"{2 * (len(long_sizes) - 1)} tensors in {tables} launches")

    lists = sgd_lists(base, dev)
    lib, _ = load_library()
    largest = max(t.numel() for layer in lists[0] for t in layer.values())
    blocks = lib.sgd_grid_blocks(largest)

    def kernel():
        sgd_update_cuda(*lists, SGD_LR, SGD_MOMENTUM, 1e-5, BUNCH)

    def plain():
        sgd_update_plain(*lists, SGD_LR, SGD_MOMENTUM, 1e-5, BUNCH)

    def empty():
        lib.sgd_launch_floor(largest, torch.cuda.current_stream().cuda_stream)

    cuda_ms, plain_ms = time_ms(kernel), time_ms(plain)
    dev_ms, dev_plain_ms = device_us(kernel) / 1e3, device_us(plain) / 1e3
    floor_us = device_us(empty)
    bound_ms = sgd_bound_ms(lists)
    print(f"sgd     full width, n={BUNCH}: sgd_update_cuda "
          f"{cuda_ms * 1e3:.1f} us/call, sgd_update_plain "
          f"{plain_ms * 1e3:.1f} us/call (events)")
    print(f"sgd     full width, n={BUNCH}: device time sgd_update_cuda "
          f"{dev_ms * 1e3:.2f} us ({blocks} blocks of 256 threads), "
          f"sgd_update_plain {dev_plain_ms * 1e3:.2f} us, an empty kernel "
          f"launched the same way {floor_us:.2f} us; bound "
          f"{bound_ms * 1e3:.2f} us (bytes: 20 per parameter at 3.35 TB/s), "
          f"{bound_ms / dev_ms:.1%} of it reached, "
          f"{HBM_BYTES_PER_S * bound_ms / dev_ms / 1e12:.3f} TB/s; "
          f"{card_line()}")
    sgd_kernel.launches = counted
    return {"max_abs_err": worst,
            "times": {"ms": dev_ms, "plain_ms": dev_plain_ms,
                      "bound_ms": bound_ms, "bound_by": "bytes"}}


def run_train(tfx: dict, init_wts: str, out_dir: str, device: str,
              *extra) -> list:
    """Train through the CLI; check its files; -> metrics.jsonl records."""
    rc = cli_main(["train", "--fea-file", tfx["noisy"],
                   "--targ-file", tfx["clean"], "--norm-file", tfx["norm"],
                   "--init-wts", init_wts, "--out-dir", out_dir,
                   "--train-sents", tfx["train_sents"],
                   "--cv-sents", tfx["cv_sents"],
                   "--traincache", str(tfx["traincache"]),
                   "--epochs", str(EPOCHS), "--device", device, *extra])
    if rc != 0:
        raise SystemExit(f"train on {device} returned {rc}")
    for name in ("mlp.1.wts", "mlp.2.wts", "mlp.1.log", "mlp.2.log",
                 "metrics.jsonl"):
        if not os.path.exists(os.path.join(out_dir, name)):
            raise SystemExit(f"train on {device} wrote no {name}")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if [r["epoch"] for r in records] != list(range(1, EPOCHS + 1)):
        raise SystemExit(f"{device} metrics.jsonl epochs: {records}")
    for r in records:
        for k in ("cv_squared_error", "cv_abs_error", "cv_ggd_loglik"):
            if not np.isfinite(r[k]):
                raise SystemExit(f"{device} epoch {r['epoch']}: {k} = {r[k]}")
    return records


def ml_bunches(tfx: dict) -> int:
    """ML bunches one training epoch takes: sum over the train range's
    chunks of floor(n_samples / M)."""
    _, _, _, ends = read_pfile_meta(tfx["noisy"])
    lo, hi = (int(x) for x in tfx["train_sents"].split("-"))
    plan = plan_chunks(ends, (lo, hi), tfx["traincache"])
    return int(sum(int(n) // BUNCH for n in plan.n_samples))


def zero_train_counts() -> None:
    """GGD and optimizer kernel launches, replayed bunches and captured
    graphs to 0."""
    ggd_kernel.launches = sgd_kernel.launches = 0
    step_mod.bunches_replayed = step_mod.graphs_captured = 0


def replay_check(label: str, bunches: int) -> str:
    """Require that ``bunches`` one-device bunches since
    ``zero_train_counts`` ran as replays of captured graphs, but for one
    eager warm-up bunch per capture. -> a line's worth of both counts."""
    replayed, captured = step_mod.bunches_replayed, step_mod.graphs_captured
    if not (captured >= 1 and replayed == bunches - captured):
        raise SystemExit(f"{label}: {replayed} bunches replayed after "
                         f"{captured} captures for {bunches} bunches")
    update_check(label)
    return f"{replayed} replayed + {captured} warm-up bunches"


def update_check(label: str) -> int:
    """Require one optimizer kernel launch per GGD kernel launch since
    ``zero_train_counts``: every bunch trained on one card here is an ML
    bunch, with one of each (replays included).  So where a phase returns
    its GGD launches, they are its updates too. -> the launches."""
    if sgd_kernel.launches != ggd_kernel.launches:
        raise SystemExit(f"{label}: {sgd_kernel.launches} optimizer kernel "
                         f"launches against {ggd_kernel.launches} GGD "
                         "launches")
    return sgd_kernel.launches


def train_phase(dev, root: str) -> dict:
    tfx = write_train_fixtures(root, SEED)
    init_wts = os.path.join(root, "init.wts")
    if cli_main(["gen-rand-net", "-o", init_wts, "--seed", str(SEED)]) != 0:
        raise SystemExit("gen-rand-net failed")
    sizes = [layer["w"].shape[0] for layer in read_wts(init_wts)]
    print(f"train   full-width model {sizes + [257]} from gen-rand-net; "
          f"fixtures {tfx['train_sents']} train / {tfx['cv_sents']} CV "
          f"sentences, traincache {tfx['traincache']}")

    want = ml_bunches(tfx) * EPOCHS
    zero_train_counts()
    t0 = time.perf_counter()
    run_train(tfx, init_wts, os.path.join(root, "cuda"), "cuda")
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    launches = ggd_kernel.launches
    print(f"train   cuda: {EPOCHS} epochs in {cuda_s:.2f} s; "
          f"ggd_kernel.launches = {launches}, ML bunches = {want} "
          f"({replay_check('train', want)})")
    if launches != want:
        raise SystemExit(f"GGD kernel launched {launches} times for {want} "
                         "ML bunches")

    run_train(tfx, init_wts, os.path.join(root, "cuda2"), "cuda")
    with open(os.path.join(root, "cuda", "mlp.2.wts"), "rb") as f1, \
            open(os.path.join(root, "cuda2", "mlp.2.wts"), "rb") as f2:
        identical = f1.read() == f2.read()
    print(f"train   second card run: mlp.2.wts byte-identical = {identical}")
    if not identical:
        raise SystemExit("two card training runs differ")
    launches += dropout_runs(tfx, init_wts, root)

    lr = ("--lrate", AGREE_LRATE)
    cuda_rec = run_train(tfx, init_wts, os.path.join(root, "cuda_lr"),
                         "cuda", *lr)
    t0 = time.perf_counter()
    cpu_rec = run_train(tfx, init_wts, os.path.join(root, "cpu_lr"), "cpu",
                        *lr)
    print(f"train   cpu at lrate {AGREE_LRATE}: {EPOCHS} epochs in "
          f"{time.perf_counter() - t0:.2f} s")
    w0 = read_wts(init_wts)
    w_cuda = read_wts(os.path.join(root, "cuda_lr", "mlp.2.wts"))
    w_cpu = read_wts(os.path.join(root, "cpu_lr", "mlp.2.wts"))
    worst_dw = 0.0
    for i, (a, g, c) in enumerate(zip(w0, w_cuda, w_cpu)):
        for k in ("w", "b"):
            d_cuda = g[k].astype(np.float64) - a[k]
            d_cpu = c[k].astype(np.float64) - a[k]
            rel = (np.linalg.norm(d_cuda - d_cpu) / np.linalg.norm(d_cpu))
            print(f"train   lrate {AGREE_LRATE} layer {i} {k}: |dW_cuda - "
                  f"dW_cpu| / |dW_cpu| = {rel:.3e} "
                  f"(|dW_cpu| = {np.linalg.norm(d_cpu):.4e})")
            worst_dw = max(worst_dw, rel)
    if not worst_dw <= TRAIN_DW_RTOL:
        raise SystemExit(f"card training moves the weights {worst_dw:.3e} "
                         "away from the CPU run's")
    worst_cv = 0.0
    for rc, rp in zip(cuda_rec, cpu_rec):
        for k in ("cv_squared_error", "cv_abs_error", "cv_ggd_loglik"):
            rel = abs(rc[k] - rp[k]) / abs(rp[k])
            print(f"train   lrate {AGREE_LRATE} epoch {rc['epoch']} {k}: "
                  f"cuda {rc[k]!r} cpu {rp[k]!r} rel {rel:.3e}")
            worst_cv = max(worst_cv, rel)
    if not worst_cv <= TRAIN_CV_RTOL:
        raise SystemExit(f"card CV metrics differ from the CPU run's by "
                         f"{worst_cv:.3e}")
    return {"launches": launches, "dw_rel": worst_dw, "cv_rel": worst_cv,
            "samples_per_s": train_rate(dev, tfx, init_wts),
            "quiet": {"wts": os.path.join(root, "cuda_lr", "mlp.2.wts"),
                      "norm": tfx["norm"]},
            "tfx": tfx, "init_wts": init_wts}


def dropout_runs(tfx: dict, init_wts: str, root: str) -> int:
    """``train --dropoutflag 1`` (the reference's 0.1 / 0.1 masks) on the
    card twice: every bunch but one warm-up per capture replayed, masks
    and all; the rerun's ``mlp.2.wts`` byte-identical, and not the
    maskless run's (``<root>/cuda``).  -> GGD launches (= updates)."""
    t0 = time.perf_counter()
    want = ml_bunches(tfx) * EPOCHS
    launches, replays = 0, []
    for name in ("dropout", "dropout_again"):
        zero_train_counts()
        run_train(tfx, init_wts, os.path.join(root, name), "cuda",
                  "--dropoutflag", "1")
        torch.cuda.synchronize()
        replays.append(replay_check(f"train --dropoutflag 1 ({name})", want))
        if ggd_kernel.launches != want:
            raise SystemExit(f"train --dropoutflag 1: {ggd_kernel.launches} "
                             f"GGD launches for {want} ML bunches")
        launches += ggd_kernel.launches
    wts = {name: os.path.join(root, name, "mlp.2.wts")
           for name in ("dropout", "dropout_again", "cuda")}
    again = same_bytes(wts["dropout"], wts["dropout_again"])
    masked = not same_bytes(wts["dropout"], wts["cuda"])
    print(f"train   --dropoutflag 1 on the card, twice ({'; '.join(replays)}"
          f"): mlp.2.wts byte-identical = {again}, not the maskless run's "
          f"= {masked}; {time.perf_counter() - t0:.2f} s")
    if not (again and masked):
        raise SystemExit("train --dropoutflag 1: a rerun differs, or the "
                         "masks changed nothing")
    return launches


def train_graph_phase(dev) -> dict:
    """``train_chunk`` replaying its captured bunch (``graph=True``)
    against its eager loop (``graph=False``) at full width, from the same
    state over the same chunk, for each of ``GRAPH_CHUNKS``: weights,
    velocity and alpha bit for bit, launches and replays counted; ms per
    bunch by the host clock (ending in a synchronise), then both again in
    turns; device busy us and launches per bunch (``torch.profiler``); the
    first call's ms, one eager warm-up bunch plus the capture; then the
    replayed chunk from a fresh state against the same chunk with the plain
    update (``train.step.sgd_momentum_update`` replaced by
    ``sgd_update_plain``), bit for bit.  -> GGD launches (= optimizer
    kernel launches)."""
    t0 = time.perf_counter()
    card = card_line()
    rng = np.random.default_rng(SEED)
    noisy = rng.normal(size=(GRAPH_FRAMES, 257)).astype(np.float32)
    clean = (0.8 * noisy + rng.normal(scale=0.1, size=noisy.shape)
             ).astype(np.float32)
    noisy, clean = (torch.from_numpy(a).to(dev) for a in (noisy, clean))
    layers = init_params(SEED, DEFAULT_LAYERSIZES)
    launches = 0
    for m, dtype, n in GRAPH_CHUNKS:
        starts = torch.from_numpy(rng.integers(
            0, GRAPH_FRAMES - 7, size=(n, m))).to(dev)
        hyper = TrainHyper(bunchsize=m, compute_dtype=dtype)
        states, first_ms, ms = {}, {}, {}

        def chunk(graph: bool, rows: torch.Tensor) -> float:
            """ms per bunch of ``rows`` on ``graph``'s state."""
            torch.cuda.synchronize()
            t = time.perf_counter()
            train_chunk(states[graph], noisy, clean, rows, GRAPH_LRATE,
                        hyper, graph=graph)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3 / rows.shape[0]

        zero_train_counts()
        for graph in (True, False):
            states[graph] = make_train_state(params_from_numpy(layers, dev))
            first_ms[graph] = chunk(graph, starts[:1])
            ms[graph] = [chunk(graph, starts[1:])]
        label = f"M={m} {dtype}"
        replays = replay_check(f"train graph {label}", n)
        if ggd_kernel.launches != 2 * n:
            raise SystemExit(f"train graph {label}: {ggd_kernel.launches} "
                             f"GGD launches for 2 x {n} bunches")
        pairs = list(zip(dp_epoch.state_tensors(states[True]),
                         dp_epoch.state_tensors(states[False])))
        if not all(torch.equal(a, b) for a, b in pairs):
            worst = max(float((a - b).abs().max()) for a, b in pairs)
            raise SystemExit(f"train graph {label}: the replayed chunk "
                             f"differs from the eager one by {worst:.3e}")
        for graph in (True, False, False, True):
            ms[graph].append(chunk(graph, starts))
        profiles = {}
        for graph in (True, False):
            busy, n_ops, _ = device_profile(
                lambda: train_chunk(states[graph], noisy, clean, starts[:1],
                                    GRAPH_LRATE, hyper, graph=graph),
                GRAPH_PROFILED, whole=True)
            profiles[graph] = (busy, n_ops)
        # A chunk read per call (device_resident="never") brings new frame
        # tensors, so its first bunch is a warm-up and a capture again.
        reserved = torch.cuda.memory_reserved()
        again = []
        for _ in range(GRAPH_RECAPTURES):
            noisy = noisy.clone()
            again.append(chunk(True, starts[:1]))
        grown = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
        eager_one = [chunk(False, starts[:1]) for _ in range(3)]
        launches += update_check(f"train graph {label}")
        # The fused update against the eager ops it replaces, over a chunk.
        zero_train_counts()
        fused = make_train_state(params_from_numpy(layers, dev))
        train_chunk(fused, noisy, clean, starts, GRAPH_LRATE, hyper)
        kernel_calls = sgd_kernel.launches
        plain = make_train_state(params_from_numpy(layers, dev))
        update = step_mod.sgd_momentum_update
        step_mod.sgd_momentum_update = sgd_update_plain
        try:
            train_chunk(plain, noisy, clean, starts, GRAPH_LRATE, hyper)
        finally:
            step_mod.sgd_momentum_update = update
        torch.cuda.synchronize()
        pairs = list(zip(dp_epoch.state_tensors(fused),
                         dp_epoch.state_tensors(plain)))
        if not (kernel_calls == sgd_kernel.launches == n
                and all(torch.equal(a, b) for a, b in pairs)):
            worst = max(float((a - b).abs().max()) for a, b in pairs)
            raise SystemExit(f"train graph {label}: the chunk with the "
                             f"optimizer kernel ({kernel_calls} launches "
                             f"for {n} bunches) differs from the plain "
                             f"update's by {worst:.3e}")
        launches += n

        def times(graph: bool) -> str:
            return ", ".join(f"{t:.4f}" for t in ms[graph])

        print(f"tgraph  {label}, full width, {n} bunches from one state "
              f"(weights, velocity and alpha bitwise equal; {replays}): "
              f"ms per bunch replayed {times(True)}, eager {times(False)} "
              f"(first timing after the first call, then in turns); first "
              f"call (one warm-up bunch + capture) {first_ms[True]:.2f} ms "
              f"against one eager bunch's {first_ms[False]:.2f} ms; with new "
              f"frames {', '.join(f'{t:.2f}' for t in again)} ms against "
              f"{', '.join(f'{t:.2f}' for t in eager_one)} ms for one eager "
              f"bunch, memory reserved {grown:+.0f} MiB over "
              f"{GRAPH_RECAPTURES} captures; device busy per "
              f"bunch (torch.profiler, {GRAPH_PROFILED} bunches) replayed "
              f"{profiles[True][0]:.1f} us over {profiles[True][1]:.0f} "
              f"launches, eager {profiles[False][0]:.1f} us over "
              f"{profiles[False][1]:.0f}; a fresh replayed chunk with the "
              f"optimizer kernel ({n} launches) bitwise equal to one with "
              f"the plain update; {card}")
    launches += dropout_graph_chunks(dev, noisy, clean, layers, rng)
    split = mesh_graph_chunks(dev, noisy, clean, layers, rng)
    print(f"tgraph  train graph phase wall time: "
          f"{time.perf_counter() - t0:.2f} s")
    return launches, split


def same_state(a, b) -> tuple[bool, float]:
    """Two states' weights, velocity and alpha -> (bit for bit, the
    largest difference)."""
    pairs = list(zip(dp_epoch.state_tensors(a), dp_epoch.state_tensors(b)))
    return (all(torch.equal(x, y) for x, y in pairs),
            max(float((x.float() - y.float()).abs().max()) for x, y in pairs))


def masks_generator(dev, chunk: int) -> torch.Generator:
    """The dropout masks' generator of a phase's ``chunk``-th chunk."""
    return torch.Generator(device=dev).manual_seed(GRAPH_MASK_SEEDS[chunk])


def dropout_graph_chunks(dev, noisy: torch.Tensor, clean: torch.Tensor,
                         layers: list, rng) -> int:
    """``train_chunk`` with dropout masks (``GRAPH_DROPOUT``), replayed
    against eager from the same state, for each of ``DROPOUT_CHUNKS``: two
    chunks with a generator each; after each chunk the two generators'
    offsets equal, after both the weights, velocity and alpha bit for bit;
    one capture for the replayed state, replays = bunches - 1; the
    weights not those of the same chunks without masks (masks were
    drawn); then ms per bunch of both in turns (the same chunks again).
    -> GGD launches (= optimizer kernel launches)."""
    launches = 0
    for m, dtype, n in DROPOUT_CHUNKS:
        chunks = [torch.from_numpy(rng.integers(
            0, GRAPH_FRAMES - 7, size=(n, m))).to(dev) for _ in range(2)]
        hyper = TrainHyper(bunchsize=m, compute_dtype=dtype,
                           dropout=GRAPH_DROPOUT)
        label = f"M={m} {dtype}, dropout {GRAPH_DROPOUT}"
        states = {graph: make_train_state(params_from_numpy(layers, dev))
                  for graph in (True, False)}
        ms = {True: [], False: []}

        def chunk(graph: bool, k: int, state=None) -> tuple[float, int]:
            """ms per bunch of chunk k on ``graph``'s state (or ``state``,
            without masks) -> (ms, the generator's offset after)."""
            gen = masks_generator(dev, k) if state is None else None
            torch.cuda.synchronize()
            t = time.perf_counter()
            train_chunk(states[graph] if state is None else state, noisy,
                        clean, chunks[k],
                        GRAPH_LRATE, hyper, generator=gen, graph=graph)
            torch.cuda.synchronize()
            return ((time.perf_counter() - t) * 1e3 / n,
                    None if gen is None else gen.get_offset())

        zero_train_counts()
        offsets = []
        for k in range(2):
            got = {graph: chunk(graph, k)[1] for graph in (True, False)}
            if not got[True] == got[False] > 0:
                raise SystemExit(f"train graph {label}: chunk {k}'s "
                                 f"generator offsets, replayed {got[True]}"
                                 f", eager {got[False]}")
            offsets.append(got[True])
        replays = replay_check(f"train graph {label}", 2 * n)
        if step_mod.graphs_captured != 1 or ggd_kernel.launches != 4 * n:
            raise SystemExit(f"train graph {label}: "
                             f"{step_mod.graphs_captured} captures, "
                             f"{ggd_kernel.launches} GGD launches for 2 x "
                             f"2 x {n} bunches")
        launches += ggd_kernel.launches
        same, worst = same_state(states[True], states[False])
        if not same:
            raise SystemExit(f"train graph {label}: the replayed chunks "
                             f"differ from the eager ones by {worst:.3e}")
        zero_train_counts()
        plain = make_train_state(params_from_numpy(layers, dev))
        for k in range(2):
            chunk(True, k, plain)
        if torch.equal(plain.model.weights[0], states[True].model.weights[0]):
            raise SystemExit(f"train graph {label}: the chunks with masks "
                             f"trained the weights of chunks without")
        for graph in (True, False, False, True):
            ms[graph].append(sum(chunk(graph, k)[0] for k in range(2)) / 2)
        launches += update_check(f"train graph {label}")

        def times(graph: bool) -> str:
            return ", ".join(f"{t:.4f}" for t in ms[graph])

        print(f"tgraph  {label}, full width, 2 chunks of {n} bunches, a "
              f"generator each, from one state (weights, velocity and "
              f"alpha bitwise equal; {replays}, one capture; generator "
              f"offsets equal after each chunk: {offsets}; weights not "
              f"those of the chunks without masks): ms per bunch replayed "
              f"{times(True)}, eager {times(False)} (in turns, both chunks "
              f"again); {card_line()}")
    return launches


def mesh_graph_chunks(dev, noisy: torch.Tensor, clean: torch.Tensor,
                      layers: list, rng) -> int:
    """One NCCL rank (a 1x1 mesh, its group joined in this process):
    each of ``GRAPH_CHUNKS``' chunks, and one M=128 chunk with dropout
    masks (``GRAPH_DROPOUT``, a generator per state seeded alike), replayed
    (``graph=True``) against the eager mesh loop (``graph=False``) from the
    same state: weights, velocity and alpha bit for bit, the split GGD and
    optimizer launches and ``Mesh.traffic`` of the two equal, the
    generators' offsets equal; then ms per bunch of each by the host
    clock (ending in a synchronise), in turns.  -> the split kernels'
    launches (each of the two; the updates as many)."""
    info = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, None,
                                  str(dev))
    first = step_mod.read_counts(None)
    cases = [(*c, None) for c in GRAPH_CHUNKS] + [
        (BUNCH, "float32", DROPOUT_CHUNKS[0][2], GRAPH_DROPOUT)]
    try:
        mesh = make_mesh(1, 1, info["device"])
        for m, dtype, n, dropout in cases:
            starts = torch.from_numpy(rng.integers(
                0, GRAPH_FRAMES - 7, size=(n, m))).to(dev)
            hyper = TrainHyper(bunchsize=m, compute_dtype=dtype,
                               dropout=dropout)
            states, counts, ms = {}, {}, {True: [], False: []}
            offsets = {}

            def chunk(graph: bool) -> float:
                gen = None if dropout is None else masks_generator(dev, 0)
                torch.cuda.synchronize()
                t = time.perf_counter()
                train_chunk(states[graph], noisy, clean, starts,
                            GRAPH_LRATE, hyper, generator=gen, mesh=mesh,
                            graph=graph)
                torch.cuda.synchronize()
                offsets[graph] = None if gen is None else gen.get_offset()
                return (time.perf_counter() - t) * 1e3 / n

            replays = (step_mod.bunches_replayed, step_mod.graphs_captured)
            for graph in (True, False):
                states[graph] = make_train_state(
                    params_from_numpy(layers, dev))
                before = step_mod.read_counts(mesh.traffic)
                chunk(graph)
                counts[graph] = [b - a for a, b in zip(
                    before, step_mod.read_counts(mesh.traffic))]
            label = (f"1 NCCL rank, M={m} {dtype}"
                     + ("" if dropout is None else f", dropout {dropout}"))
            replays = (step_mod.bunches_replayed - replays[0],
                       step_mod.graphs_captured - replays[1])
            if replays != (n - 1, 1):
                raise SystemExit(f"train graph {label}: {replays[0]} "
                                 f"bunches replayed after {replays[1]} "
                                 f"captures for {n} bunches")
            if offsets[True] != offsets[False]:
                raise SystemExit(f"train graph {label}: generator offsets "
                                 f"{offsets}")
            same, worst = same_state(states[True], states[False])
            if not same:
                raise SystemExit(f"train graph {label}: the replayed chunk "
                                 f"differs from the eager one by "
                                 f"{worst:.3e}")
            split = [0, n, n, n]
            if not (counts[True] == counts[False]
                    and counts[True][:4] == split):
                raise SystemExit(f"train graph {label}: launches and "
                                 f"collectives (fused, colsum, from_sums, "
                                 f"update, calls and bytes per axis and op) "
                                 f"replayed {counts[True]}, eager "
                                 f"{counts[False]}")
            for graph in (True, False, False, True):
                ms[graph].append(chunk(graph))
            masks = ("" if dropout is None else
                     f"; generator offsets equal ({offsets[True]})")
            print(f"tgraph  {label}, full width, {n} bunches from one state "
                  f"(weights, velocity and alpha bitwise equal to the eager "
                  f"mesh loop's; {replays[0]} replayed + 1 warm-up bunch; "
                  f"split GGD and optimizer "
                  f"launches and collectives equal: "
                  f"{counts[True][4:]} calls and bytes per axis and op"
                  f"{masks}): ms per bunch replayed "
                  f"{', '.join(f'{t:.4f}' for t in ms[True])}, eager "
                  f"{', '.join(f'{t:.4f}' for t in ms[False])} (in turns); "
                  f"{card_line()}")
    finally:
        shutdown_distributed()
    moved = [b - a for a, b in zip(first, step_mod.read_counts(None))]
    if not moved[0] == 0 < moved[1] == moved[2] == moved[3]:
        raise SystemExit(f"train graph, 1 NCCL rank: launches (fused, "
                         f"colsum, from_sums, update) {moved}")
    return moved[1]


# The train-graph phase runs in a child process.  On an H100 (torch 2.11)
# a process that traced training bunches with torch.profiler and then
# captured more bunch graphs (the per-chunk and pipeline training runs)
# lost the first device record of every later trace window: the streaming
# phase's whole-window hop profiles then failed, in every window.  Neither
# alone did it.  The child keeps those traces out of this process, whose
# later traces (bf16 phase) take eager bunches.
GRAPH_CHILD = """
import torch
import chip_smoke
print("tgraph-launches",
      *chip_smoke.train_graph_phase(torch.device("cuda")))
"""


def train_graph_child(root: str) -> tuple[int, int]:
    """``train_graph_phase`` in a child process on the card, its lines
    printed here.  -> its fused GGD launches (= its one-device updates)
    and its split GGD launches of each kind (= its mesh updates)."""
    text, = wait_ranks([start_rank(["-u", "-c", GRAPH_CHILD],
                                   os.path.join(root, "train_graph.log"))],
                       "train graph")
    lines = text.splitlines()
    launches = [tuple(int(x) for x in line.split()[1:]) for line in lines
                if line.startswith("tgraph-launches ")]
    if len(launches) != 1:
        raise SystemExit(f"train graph: {text[-3000:]}")
    for line in lines:
        if line.startswith("tgraph  "):
            print(line)
    return launches[0]


def train_rate(dev, tfx: dict, init_wts: str,
               compute_dtype: str = "float32", resident: bool = True,
               use_native: bool | None = None) -> float:
    """Informational: training samples/s of epoch 1 on the card (no CV),
    host clock around the epoch ending in a synchronise.  ``resident``:
    the span uploaded once beforehand; else every chunk is read (through
    the host chunk loader, or numpy with ``use_native=False``) and
    uploaded inside the epoch, as ``device_resident="never"`` trains."""
    cfg = TrainConfig(train_sent_range=tuple(
        int(x) for x in tfx["train_sents"].split("-")),
        traincache=tfx["traincache"], compute_dtype=compute_dtype)
    ds = PfilePairDataset(tfx["noisy"], tfx["clean"], tfx["norm"],
                          cfg.train_sent_range, cfg.traincache,
                          use_native=use_native)
    frames = load_device_frames(ds, dev) if resident else None
    state = load_checkpoint(init_wts, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_one_epoch(state, ds, cfg.hyper(), cfg.lr_for_epoch(1),
                    np.random.default_rng(cfg.seed_for_epoch(1)), dev,
                    device_frames=frames, log=lambda s: None)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    samples = ml_bunches(tfx) * BUNCH
    route = ("resident frames" if resident else
             "per-chunk reads, " + ("numpy" if use_native is False
                                    else "host chunk loader"))
    print(f"train   epoch 1 on the card, no CV, {compute_dtype}, {route}: "
          f"{samples} samples in "
          f"{dt:.4f} s = {samples / dt:.0f} samples/s "
          f"({samples // BUNCH} bunches, {dt / (samples // BUNCH) * 1e3:.3f} "
          f"ms per bunch)")
    return samples / dt


def cli(argv: list) -> str:
    """Run the port's CLI in-process; fail on a non-zero exit; -> stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    if rc != 0:
        raise SystemExit(f"{' '.join(argv[:2])} ... returned {rc}")
    return out.getvalue()


def read_list(path: str) -> list[str]:
    with open(path) as f:
        return f.read().split()


def write_list(path: str, items: list[str]) -> str:
    with open(path, "w") as f:
        f.write("".join(f"{item}\n" for item in items))
    return path


def lps_path(wav: str) -> str:
    return wav.rsplit(".", 1)[0] + ".lps"


def finetune_args(p: dict, init_wts: str, out_dir: str, epoch: int,
                  *extra) -> list:
    """The key=value strings of ``finetune.pl``'s iteration ``epoch``
    (finetune.pl:50-76, as tests/test_bptrain_cli.py lists them), cut to
    the corpus: 20 training and 4 CV sentences, traincache 1024."""
    return [
        "gpu_used=0", "numlayers=4", "layersizes=1799,2048,2048,2048,257",
        "bunchsize=128", "MLflag=1", "shapefactor=1", "momentum=0.9",
        "weightcost=0.00001", "lrate=0.1", "fea_dim=257", "fea_context=7",
        f"traincache={p['traincache']}",
        f"init_randem_seed={FINETUNE_SEED + SEED_STEP * (epoch - 1)}",
        "targ_offset=3", f"initwts_file={init_wts}",
        f"norm_file={p['norm']}", f"fea_file={p['noisy']}",
        f"targ_file={p['clean']}",
        f"outwts_file={out_dir}/mlp.{epoch}.wts",
        f"log_file={out_dir}/mlp.{epoch}.log",
        f"train_sent_range={p['train_sents']}",
        f"cv_sent_range={p['cv_sents']}",
        "dropoutflag=0", "visible_omit=0.1", "hid_omit=0.1", "device=cuda",
        *extra]


def extract_lps(root: str, cx: dict) -> tuple[int, dict]:
    """``lps-extract`` over the corpus on the card (``--jobs 4``), then on
    the CPU over a copy; holds the two sets of ``.lps`` files to each
    other.  -> (LPS kernel launches of the card runs, ms per file)."""
    cpu_scp = {}
    for kind in ("noisy", "clean"):
        cpu_dir = os.path.join(root, "cpu", kind)
        shutil.copytree(cx[f"{kind}_dir"], cpu_dir)
        cpu_scp[kind] = write_list(
            os.path.join(root, "cpu", f"{kind}.scp"),
            [os.path.join(cpu_dir, os.path.basename(w))
             for w in read_list(cx[f"{kind}_scp"])])
    wavs = read_list(cx["noisy_scp"]) + read_list(cx["clean_scp"])

    def on_card() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for kind in ("noisy", "clean"):
            cli(["lps-extract", "--scp", cx[f"{kind}_scp"], "--device",
                 "cuda", "--jobs", "4"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(wavs)

    # Before: the analysis basis built and uploaded for every file, which
    # is what a call without the per-device cache does.  After: as shipped.
    ms = {}
    resident = analysis._resident_basis
    analysis._resident_basis = resident.__wrapped__
    try:
        on_card()                                   # warm: library, files
        ms["cuda_basis_per_file"] = on_card()
    finally:
        analysis._resident_basis = resident
    lps_kernel.launches = 0
    ms["cuda"] = on_card()
    launches = lps_kernel.launches
    print(f"pipe    lps-extract --device cuda --jobs 4: {len(wavs)} files, "
          f"{ms['cuda']:.3f} ms per file with the basis kept on the card, "
          f"{ms['cuda_basis_per_file']:.3f} ms per file with the basis "
          f"uploaded per file; lps_kernel.launches = {launches}")
    if launches != len(wavs):
        raise SystemExit(f"lps-extract launched the LPS kernel {launches} "
                         f"times for {len(wavs)} files")

    t0 = time.perf_counter()
    for kind in ("noisy", "clean"):
        cli(["lps-extract", "--scp", cpu_scp[kind], "--device", "cpu",
             "--jobs", "4"])
    ms["cpu"] = (time.perf_counter() - t0) * 1e3 / len(wavs)
    worst = 0.0
    for wav in wavs:
        with open(lps_path(wav), "rb") as f:
            got = f.read()
        cpu_wav = os.path.join(root, "cpu", os.path.basename(
            os.path.dirname(wav)), os.path.basename(wav))
        with open(lps_path(cpu_wav), "rb") as f:
            want = f.read()
        if got[:12] != want[:12] or len(got) != len(want):
            raise SystemExit(f"{wav}: card and CPU .lps headers or sizes "
                             "differ")
        a, b = (np.frombuffer(x[12:], ">f4") for x in (got, want))
        if not np.isfinite(a).all():
            raise SystemExit(f"{wav}: non-finite LPS from the card")
        worst = max(worst, float(np.abs(a - b).max()))
    print(f"pipe    lps-extract --device cpu: {ms['cpu']:.3f} ms per file; "
          f"headers identical, max |cuda-cpu| = {worst:.3e}")
    if not worst <= LPS_ATOL:
        raise SystemExit(f"card .lps differ from the CPU's by {worst:.3e}")
    return launches, ms


def pack(root: str, cx: dict) -> dict:
    """``make-pfile`` (noisy with --lenfile, clean with --deslenfile),
    ``get-norm``, ``concat-pfile`` and ``pfile-info --sents``."""
    n = len(read_list(cx["noisy_scp"]))
    p = {k: os.path.join(root, name) for k, name in (
        ("noisy", "noisy.pfile"), ("clean", "clean.pfile"),
        ("len", "frame_numbers.len"), ("norm", "noisy.norm"),
        ("both", "both.pfile"))}
    scp = {kind: write_list(os.path.join(root, f"{kind}_lps.scp"),
                            [lps_path(w) for w in read_list(cx[f"{kind}_scp"])])
           for kind in ("noisy", "clean")}
    cli(["make-pfile", scp["noisy"], "-o", p["noisy"], "--lenfile", p["len"],
         "--jobs", "4"])
    cli(["make-pfile", scp["clean"], "-o", p["clean"],
         "--deslenfile", p["len"]])
    cli(["get-norm", p["noisy"], "-o", p["norm"]])
    lens = [int(x) for x in read_list(p["len"])]
    total = sum(lens)
    for name in ("noisy", "clean"):
        got = read_pfile_meta(p[name])[:3]
        if len(lens) != n or got != (n, total, 257):
            raise SystemExit(f"{name} pfile holds {got}, lenfile {len(lens)} "
                             f"sentences of {total} frames")
    mean, inv_std = read_norm(p["norm"])
    if mean.shape != (257,) or not (np.isfinite(mean).all()
                                    and np.isfinite(inv_std).all()):
        raise SystemExit("get-norm wrote no finite 257-dim statistics")
    cli(["concat-pfile", p["noisy"], p["clean"], "-o", p["both"]])
    if read_pfile_meta(p["both"])[:3] != (2 * n, 2 * total, 257):
        raise SystemExit(f"concat-pfile: {read_pfile_meta(p['both'])[:3]}")
    info = cli(["pfile-info", "--sents", p["noisy"]]).splitlines()
    want = ([f"{p['noisy']}: {n} sentences, {total} frames, 257 features"]
            + [f"  sentence {i}: {t} frames" for i, t in enumerate(lens)])
    if info != want:
        raise SystemExit(f"pfile-info --sents printed {info[:3]} ...")
    print(f"pipe    make-pfile/get-norm/concat-pfile/pfile-info: {n} "
          f"sentences, {total} frames x 257; concat {2 * n} sentences")
    return {**p, "train_sents": cx["train_sents"], "cv_sents": cx["cv_sents"],
            "traincache": cx["traincache"]}


def check_log(path: str) -> list[float]:
    """A bptrain log's three CV values, which must be finite, and its
    device and time lines."""
    with open(path) as f:
        lines = f.read().splitlines()
    values = [float(line.split(":")[1]) for line in lines if line.startswith((
        "CV over. squared error:", "CV over. square root squared error:",
        "CV2 over. CV log likelihood:"))]
    if len(values) != 3 or not all(math.isfinite(v) for v in values):
        raise SystemExit(f"{path}: CV lines {values}")
    if not any(line.startswith("torch device: cuda (") for line in lines) or \
            not any(line.startswith("Total cost time: ") for line in lines):
        raise SystemExit(f"{path}: no card device line or no time line")
    return values


def chain(root: str, p: dict) -> int:
    """``gen-rand-net``, ``wts-info``, two chained ``bptrain`` epochs on the
    card and ``train --epochs 2`` from the same init and seed.
    -> GGD kernel launches of the chain and of ``train``."""
    init = os.path.join(root, "init.wts")
    cli(["gen-rand-net", "-o", init, "--seed", str(SEED)])
    params = sum(layer["w"].size + layer["b"].size for layer in read_wts(init))
    info = cli(["wts-info", init])
    if f"  total: {params} parameters " not in info:
        raise SystemExit(f"wts-info: no 'total: {params} parameters' in "
                         f"{info!r}")
    want = ml_bunches(p)
    out = os.path.join(root, "chain")
    os.makedirs(out)
    launches = 0
    for epoch in (1, 2):
        start = init if epoch == 1 else os.path.join(out, "mlp.1.wts")
        zero_train_counts()
        t0 = time.perf_counter()
        cli(["bptrain", *finetune_args(p, start, out, epoch)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        values = check_log(os.path.join(out, f"mlp.{epoch}.log"))
        print(f"pipe    bptrain epoch {epoch} on the card: {dt:.2f} s; "
              f"ggd_kernel.launches = {ggd_kernel.launches}, ML bunches = "
              f"{want} ({replay_check(f'bptrain epoch {epoch}', want)}); "
              f"CV squared error, abs, GGD loglik = {values}")
        if ggd_kernel.launches != want:
            raise SystemExit(f"bptrain epoch {epoch}: GGD kernel launched "
                             f"{ggd_kernel.launches} times for {want} bunches")
        launches += ggd_kernel.launches
    sidecars = [f for d in (root, out) for f in os.listdir(d)
                if f.endswith(".state.npz")]
    if sidecars:
        raise SystemExit(f"bptrain wrote state sidecars: {sidecars}")

    zero_train_counts()
    cli(["train", "--fea-file", p["noisy"], "--targ-file", p["clean"],
         "--norm-file", p["norm"], "--init-wts", init,
         "--out-dir", os.path.join(root, "train"),
         "--train-sents", p["train_sents"], "--cv-sents", p["cv_sents"],
         "--traincache", str(p["traincache"]), "--seed", str(FINETUNE_SEED),
         "--epochs", "2", "--device", "cuda"])
    torch.cuda.synchronize()
    if ggd_kernel.launches != 2 * want:
        raise SystemExit(f"train: GGD kernel launched {ggd_kernel.launches} "
                         f"times for {2 * want} bunches")
    replays = replay_check("train --epochs 2", 2 * want)
    launches += ggd_kernel.launches
    for name in ("mlp.1.wts", "mlp.2.wts"):
        with open(os.path.join(out, name), "rb") as f1, \
                open(os.path.join(root, "train", name), "rb") as f2:
            if f1.read() != f2.read():
                raise SystemExit(f"bptrain chain and train --epochs 2 "
                                 f"differ in {name}")
    print(f"pipe    train --epochs 2 on the card ({replays}): mlp.1.wts "
          f"and mlp.2.wts byte-identical to the bptrain chain's")
    return launches


def score(clean: list, enhanced: list, label: str) -> list:
    """``eval --json`` of clean against enhanced -> its rows, all finite."""
    text = cli(["eval", "--json", "--clean", *clean, "--test", *enhanced])
    rows = [json.loads(line) for line in text.splitlines()]
    for row in rows:
        print(f"pipe    eval ({label}) {json.dumps(row)}")
    if [r["name"] for r in rows] != enhanced + ["mean"] or not all(
            math.isfinite(r[m]) for r in rows
            for m in ("segsnr", "lsd", "stoi", "pesq")):
        raise SystemExit(f"eval ({label}): rows missing or metrics not "
                         "finite")
    return rows


def enhance_and_score(root: str, cx: dict, p: dict, quiet: dict) -> int:
    """``decode --device cuda`` of the CV sentences with the chain's weights
    and the ``get-norm`` statistics, then ``eval --json`` against the clean
    wavs; then both again with ``quiet``, the weights and statistics of a
    training run whose model stays inside int16.  -> LPS kernel launches
    of the card's decodes."""
    lo, hi = (int(x) for x in p["cv_sents"].split("-"))
    noisy = read_list(cx["noisy_scp"])[lo:hi + 1]
    clean = read_list(cx["clean_scp"])[lo:hi + 1]
    out = os.path.join(root, "enhanced")
    lps_kernel.launches = 0
    cli(["decode", *noisy, "--wts", os.path.join(root, "chain", "mlp.2.wts"),
         "--norm", p["norm"], "--out-dir", out, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = lps_kernel.launches
    if launches <= 0:
        raise SystemExit("decode of the CV sentences launched no LPS kernel")
    enhanced = [os.path.join(out, os.path.splitext(os.path.basename(w))[0]
                             + "_enhanced.wav") for w in noisy]

    # Two epochs at lrate 0.1 leave a model that speaks far louder than the
    # clean speech: its float waves leave the int16 range and wrap, so the
    # card's and the CPU's int16 waves differ after the wrap by far more
    # than 1 LSB.  The decode of this model is held to the CPU's by its
    # enhanced LPS (float32 GEMMs summed in another order).
    wts = os.path.join(root, "chain", "mlp.2.wts")
    card = Enhancer(wts, p["norm"], device="cuda")
    host = Enhancer(wts, p["norm"], device="cpu")
    worst, loud, clean_peak = 0.0, 0.0, 0
    for path, clean_path in zip(noisy, clean):
        wave = read_wav(path)[0]
        _, recon, enh = card.enhance(wave)
        worst = max(worst, float(np.abs(enh - host.enhance(wave)[2]).max()))
        loud = max(loud, float(np.abs(recon).max()))
        clean_peak = max(clean_peak, int(np.abs(
            read_wav(clean_path)[0].astype(np.int32)).max()))
    print(f"pipe    decode of {len(noisy)} CV sentences: max |enhanced LPS "
          f"cuda-cpu| = {worst:.3e}; peak |recon frame| {loud:.1f}, clean "
          f"peak {clean_peak}")
    if not worst <= DECODE_LPS_ATOL:
        raise SystemExit(f"the chain's model decodes {worst:.3e} away from "
                         "the CPU's enhanced LPS")
    loud_rows = score(clean, enhanced, "lrate 0.1 chain")

    # A model that does not overflow: two epochs at lrate 0.001.  Its
    # float waves stay within a few int16 ranges, where float32 resolves
    # far below 1 LSB, so the card's waves are held to the CPU's sample by
    # sample; its SegSNR must beat the overflowing model's, which sits at
    # the metric's floor of -20.
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = os.path.join(root, f"enhanced_quiet_{device}")
        lps_kernel.launches = 0
        cli(["decode", *noisy, "--wts", quiet["wts"], "--norm", quiet["norm"],
             "--out-dir", outs[device], "--device", device])
        if device == "cuda":
            torch.cuda.synchronize()
            launches += lps_kernel.launches
    names = [os.path.basename(path) for path in enhanced]
    worst, peak = 0, 0
    for name in names:
        got = read_wav(os.path.join(outs["cuda"], name))[0]
        ref = read_wav(os.path.join(outs["cpu"], name))[0]
        if len(got) != len(ref):
            raise SystemExit(f"{name}: card and CPU lengths differ")
        worst = max(worst, wrapped_lsb(got, ref))
        peak = max(peak, int(np.abs(got.astype(np.int32)).max()))
    print(f"pipe    decode with the lrate {AGREE_LRATE} weights: max "
          f"|cuda-cpu| = {worst} LSB, peak |sample| {peak}")
    if worst > 1:
        raise SystemExit(f"the lrate {AGREE_LRATE} model's waves differ from "
                         f"the CPU's by {worst} LSB")
    rows = score(clean, [os.path.join(outs["cuda"], n) for n in names],
                 f"lrate {AGREE_LRATE}")
    if not rows[-1]["segsnr"] > max(-20.0, loud_rows[-1]["segsnr"]):
        raise SystemExit(f"the lrate {AGREE_LRATE} model's SegSNR "
                         f"{rows[-1]['segsnr']} is not above the "
                         f"overflowing model's {loud_rows[-1]['segsnr']}")
    return launches


def pipeline_phase(root: str, quiet: dict) -> dict:
    """wav -> .lps -> pfile -> .norm -> bptrain chain -> decode -> eval,
    through the CLI on the card."""
    t0 = time.perf_counter()
    cx = write_corpus_fixtures(os.path.join(root, "corpus"), SEED)
    lps_launches, ms = extract_lps(root, cx)
    p = pack(root, cx)
    ggd_launches = chain(root, p)
    lps_launches += enhance_and_score(root, cx, p, quiet)
    seconds = time.perf_counter() - t0
    print(f"pipe    pipeline phase wall time: {seconds:.2f} s")
    return {"lps_launches": lps_launches, "ggd_launches": ggd_launches,
            "seconds": seconds, "ms_per_file": ms}


def stream_files(fx: dict, out_dir: str, device: str) -> list[np.ndarray]:
    """``decode --stream`` of the fixture utterances through the CLI ->
    the enhanced waves, each with its printed latency line checked."""
    text = cli(["decode", "--scp", fx["scp"], "--wts", fx["wts"],
                "--norm", fx["norm"], "--out-dir", out_dir,
                "--stream", str(STREAM_CHUNK), "--device", device])
    waves = []
    for line, path in zip(text.splitlines(), read_list(fx["scp"])):
        stem = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(out_dir, stem + "_enhanced.wav")
        if line != (f"{stem}: streamed ({STREAM_CHUNK}-sample chunks, 80 ms "
                    f"algorithmic latency) -> {out}"):
            raise SystemExit(f"decode --stream printed {line!r}")
        waves.append(read_wav(out)[0])
    return waves


def stream_cli(root: str, fx: dict) -> int:
    """The streaming path as a user drives it, with the counts set to 0
    just before and read just after.  -> LPS kernel launches."""
    hops = sum(len(w) // SHIFT for w in fx["waves"])
    lps_kernel.launches = 0
    streaming.hops_replayed = 0
    got = stream_files(fx, os.path.join(root, "stream", "cuda"), "cuda")
    torch.cuda.synchronize()
    replays, eager = streaming.hops_replayed, lps_kernel.launches
    print(f"stream  decode --stream {STREAM_CHUNK} --device cuda: {hops} "
          f"hops pushed, {replays} graph replays (one LPS kernel launch "
          f"each), {eager} lps_cuda calls besides (one warm-up, one "
          f"capture: one enhancer served the {len(got)} files)")
    if replays != hops or eager != 2:
        raise SystemExit(f"streamed {hops} hops in {replays} replays and "
                         f"{eager} lps_cuda calls")
    host = stream_files(fx, os.path.join(root, "stream", "cpu"), "cpu")
    stems = [os.path.splitext(os.path.basename(p))[0]
             for p in read_list(fx["scp"])]
    worst_batch = worst_cpu = 0
    for stem, wave, cpu_wave in zip(stems, got, host):
        batch, _ = read_wav(os.path.join(root, "plain", "cuda",
                                         stem + "_enhanced.wav"))
        if not len(wave) == len(batch) == len(cpu_wave):
            raise SystemExit(f"{stem}: streamed {len(wave)} samples, batch "
                             f"{len(batch)}, CPU stream {len(cpu_wave)}")
        worst_batch = max(worst_batch, wrapped_lsb(wave, batch))
        worst_cpu = max(worst_cpu, wrapped_lsb(wave, cpu_wave))
    print(f"stream  {len(got)} utterances: max |stream - card batch decode| "
          f"= {worst_batch} LSB, max |stream cuda-cpu| = {worst_cpu} LSB")
    if worst_batch > 1 or worst_cpu > 1:
        raise SystemExit("the streamed waves differ by more than 1 LSB")
    return replays + eager


def stream_library(fx: dict) -> None:
    """8 streams, quality options on: replayed against eager on the card
    (bitwise), against the CPU (1 LSB), and the kernels of one hop."""
    kw = {"n_streams": 8, "blend": "auto", "smooth_strength": "auto"}
    hops = stream_hops(fx["waves"], 8, 8 * CHUNK_HOPS)
    outs = {}
    streamers = {"replayed": StreamingEnhancer(fx["wts"], fx["norm"], **kw),
                 "eager": StreamingEnhancer(fx["wts"], fx["norm"],
                                            graph=False, **kw),
                 "cpu": StreamingEnhancer(fx["wts"], fx["norm"],
                                          device="cpu", **kw)}
    streaming.hops_replayed = 0
    for name, s in streamers.items():
        chunks = [s.push_many(hops[:, lo:lo + CHUNK_HOPS], int16_wire=True)[0]
                  for lo in range(0, hops.shape[1], CHUNK_HOPS)]
        outs[name] = np.concatenate(chunks + [
            np.trunc(out).astype(np.int16)[:, None] for out in s.flush_hops()],
            axis=1)
    same = np.array_equal(outs["replayed"], outs["eager"]) and all(
        torch.equal(x, y) for x, y in zip(streamers["replayed"].state,
                                          streamers["eager"].state))
    finite = all(bool(torch.isfinite(x).all())
                 for x in streamers["replayed"].state)
    worst = wrapped_lsb(outs["replayed"].ravel(), outs["cpu"].ravel())
    print(f"stream  8 streams x {hops.shape[1]} hops, push_many(K="
          f"{CHUNK_HOPS}, int16 wire), blend=auto smooth_strength=auto: "
          f"replayed == eager bitwise (outputs and final state) = {same}; "
          f"state finite = {finite}; max |cuda-cpu| = {worst} LSB; "
          f"{streaming.hops_replayed} replays")
    if not (same and finite and worst <= 1
            and streaming.hops_replayed == hops.shape[1]):
        raise SystemExit("the replayed step disagrees with the eager step "
                         "or the CPU")
    for name in ("eager", "replayed"):
        hop_profile(streamers[name], f"one {name} hop at S=8, both options "
                                     f"auto")


# A hop's device time by what does it: substrings of the kernels' names.
HOP_GROUPS = (("LPS kernel", ("lps_kernel",)),
              ("FFN products", ("gemm", "gemv", "splitKreduce", "nvjet")),
              ("sigmoid", ("sigmoid",)),
              ("FFT", ("fft",)),
              ("copies", ("Memcpy", "memcpy", "direct_copy")))


def hop_profile(streamer: StreamingEnhancer, label: str) -> dict:
    """Print one step's device launches and busy time from
    ``torch.profiler`` (mean of 10 steps), grouped by ``HOP_GROUPS``, and
    the kernel that takes most of it; the step must hold exactly one LPS
    kernel, in one of three traces (a step launches the same kernels every
    time, so a fault of the step shows in every trace, a lost record in one).
    -> the launches, the busy us and the network's products' us."""
    for _ in range(3):
        with torch.inference_mode():
            busy, launches, kernels = device_profile(streamer._run_step, 10,
                                                     whole=True)
        lps = sum(n for name, _, n in kernels if "lps_kernel" in name)
        if lps == 1:
            break
        print(f"stream  {label}: a trace with {lps:.1f} LPS kernels per hop; "
              f"profiled again")
    groups = dict.fromkeys([g for g, _ in HOP_GROUPS] + ["elementwise"], 0.0)
    for name, us, _ in kernels:
        group = next((g for g, keys in HOP_GROUPS
                      if any(k in name for k in keys)), "elementwise")
        groups[group] += us
    top, top_us, top_n = kernels[0]
    print(f"stream  {label} (torch.profiler, 10 hops): {launches:.1f} device "
          f"launches, {lps:.1f} of them the LPS kernel; busy {busy:.1f} us: "
          + ", ".join(f"{g} {us:.1f}" for g, us in groups.items())
          + f"; largest: {top_n:.0f} x {top[:72]} {top_us:.1f} us")
    if lps != 1:
        raise SystemExit(f"{label}: {lps} LPS kernels in a hop")
    return {"launches": launches, "busy_us": busy,
            "ffn_us": groups["FFN products"]}


def stream_times(fx: dict) -> dict:
    """Per hop at each stream count: the step alone on the card (eager and
    replayed, CUDA events over back-to-back steps), ``push`` as a caller
    sees it (host clock, the copies each way included), and ``push_many``
    hops/s on both wires.  -> per stream count, the replayed hop's profile
    and time (float32, for the bfloat16 phase to print beside its own)."""
    hop_ms = SHIFT / SAMPLE_RATE * 1e3
    seen = {}
    for n in STREAM_COUNTS:
        hops = stream_hops(fx["waves"], n, PUSH_CALLS)
        eager = StreamingEnhancer(fx["wts"], fx["norm"], n_streams=n,
                                  graph=False)
        s = StreamingEnhancer(fx["wts"], fx["norm"], n_streams=n)
        with torch.inference_mode():
            for enh in (eager, s):     # a warm state: frames in every ring
                enh.push_many(hops[:, :16], int16_wire=True)
            eager_us = time_ms(eager._run_step, iters=50) * 1e3
            replay_us = time_ms(s._run_step, iters=200) * 1e3
        seen[n] = {**hop_profile(s, f"one replayed hop at S={n}"),
                   "replay_us": replay_us}
        wall = []
        for j in range(PUSH_CALLS):
            hop = hops[:, j].astype(np.float32)
            t0 = time.perf_counter()
            s.push(hop)
            wall.append((time.perf_counter() - t0) * 1e6)
        p50, p99 = np.percentile(wall, [50, 99])
        rate = {}
        for wire in ("float32", "int16"):
            chunk = hops[:, :CHUNK_HOPS]
            if wire == "float32":
                chunk = chunk.astype(np.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(40):
                s.push_many(chunk, int16_wire=wire == "int16")
            rate[wire] = 40 * CHUNK_HOPS / (time.perf_counter() - t0)
        print(f"stream  S={n:3d}: step alone on the card eager "
              f"{eager_us:.1f} us, replayed {replay_us:.1f} us per hop "
              f"({1e6 / replay_us:.0f} hops/s = "
              f"{n * hop_ms * 1e3 / replay_us:.0f} channels x real time); "
              f"push() wall p50 {p50:.1f} us, p99 {p99:.1f} us over "
              f"{PUSH_CALLS} calls ({n * hop_ms * 1e3 / p50:.0f} channels x "
              f"real time at p50); push_many(K={CHUNK_HOPS}) "
              f"{rate['float32']:.0f} hops/s float32 wire, "
              f"{rate['int16']:.0f} hops/s int16 wire "
              f"({n * hop_ms / 1e3 * rate['int16']:.0f} channels x real time)")
    return seen


def stream_phase(root: str, fx: dict) -> tuple[int, dict]:
    """-> LPS kernel launches of the streamed decode, and the float32
    hops' times per stream count."""
    t0 = time.perf_counter()
    launches = stream_cli(root, fx)
    stream_library(fx)
    seen = stream_times(fx)
    print(f"stream  streaming phase wall time: "
          f"{time.perf_counter() - t0:.2f} s")
    return launches, seen


def bf16_forward(dev, fx: dict) -> None:
    """The bfloat16 network on the card against the CPU's formulation, and
    one linear layer alone, forward and backward."""
    layers = read_wts(fx["wts"])
    host = params_from_numpy(layers, "cpu")
    card = params_from_numpy(layers, dev)
    cast = card.cast_weights(torch.bfloat16)
    rng = np.random.default_rng(SEED)
    for m in BF16_ROWS:
        x = torch.from_numpy(rng.standard_normal(
            (m, layers[0]["w"].shape[0])).astype(np.float32))
        with torch.no_grad():
            # Layer by layer, the card's layer on the CPU's own input: only
            # the order of the float32 sums differs.
            h, layer_errs = x, []
            for i, (w, b) in enumerate(zip(host.weights, host.biases)):
                z = reduced_linear(h, w, b, torch.bfloat16)
                z_card = reduced_linear(h.to(dev), card.weights[i],
                                        card.biases[i], torch.bfloat16,
                                        cast[i])
                layer_errs.append((z_card.cpu() - z).abs().max().item()
                                  / z.abs().max().item())
                h = torch.sigmoid(z)
            want = host(x, compute_dtype=torch.bfloat16)
            if not torch.equal(want, z):
                raise SystemExit("FFN.forward is not the chain of its layers")
            if m <= BUNCH:
                # Hidden activations are rounded to bfloat16 by the next
                # product anyway, so act_dtype=bfloat16 changes no bit.
                again = host(x, compute_dtype=torch.bfloat16,
                             act_dtype=torch.bfloat16)
                if not torch.equal(again, want):
                    raise SystemExit("act_dtype=bfloat16 changes the CPU's "
                                     f"bfloat16 forward at M={m}")
            errs = []
            for act_dtype in (None, torch.bfloat16):
                got = card(x.to(dev), compute_dtype=torch.bfloat16,
                           act_dtype=act_dtype, cast_weights=cast)
                if got.dtype != torch.float32:
                    raise SystemExit(f"bfloat16 forward returns {got.dtype}")
                errs.append((got.cpu() - want).abs().max().item())
            gap = (card(x.to(dev)).cpu() - want).abs().max().item()
        tol = BF16_NET_SHARE * gap
        print(f"bf16    FFN M={m:4d}: each layer on the CPU's input, max "
              f"|cuda-cpu| / max|z| = "
              f"{', '.join(f'{e:.2e}' for e in layer_errs)} (tolerance "
              f"{BF16_PRODUCT_RTOL}); whole network max |cuda-cpu| = "
              f"{errs[0]:.3e} (act_dtype=bfloat16: {errs[1]:.3e}), tolerance "
              f"{tol:.3e} = {BF16_NET_SHARE} x the float32 network's "
              f"distance {gap:.3e} (max|out| "
              f"{want.abs().max().item():.3f})")
        if not (max(layer_errs) <= BF16_PRODUCT_RTOL and max(errs) <= tol):
            raise SystemExit(f"bfloat16 forward on the card differs from "
                             f"the CPU's at M={m}")

    h, w, g = (rng.standard_normal(shape).astype(np.float32) * scale
               for shape, scale in (((BUNCH, 2048), 1.0),
                                    ((2048, 2048), 0.05),
                                    ((BUNCH, 2048), 1.0)))
    b = rng.standard_normal(2048).astype(np.float32)
    results = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        ht, wt, bt = (torch.from_numpy(a).to(device).requires_grad_()
                      for a in (h, w, b))
        z = reduced_linear(ht, wt, bt, torch.bfloat16)
        grads = torch.autograd.grad(z, (ht, wt, bt),
                                    torch.from_numpy(g).to(device))
        results[name] = [t.detach().cpu() for t in (z, *grads)]
    line = []
    for name, got, want in zip(("z", "dh", "dW", "db"), *results.values()):
        tol = ((BF16_ULP if name in ("dh", "dW") else BF16_PRODUCT_RTOL)
               * want.abs().max().item())
        err = (got - want).abs().max().item()
        line.append(f"{name} {err:.3e} (tolerance {tol:.3e})")
        if got.dtype != torch.float32 or not err <= tol:
            raise SystemExit(f"bfloat16 linear layer: {name} on the card is "
                             f"{got.dtype}, {err:.3e} from the CPU's")
    # Informational, for a later PR: does the tensor cores' bfloat16-output
    # product round its float32 sums once, as the explicit rounding does?
    a16 = torch.from_numpy(h).to(dev).bfloat16().t().contiguous()
    g16 = torch.from_numpy(g).to(dev).bfloat16()
    direct = torch.mm(a16, g16)
    explicit = reduced_product(a16, g16).to(torch.bfloat16)
    print(f"bf16    one layer [{BUNCH}, 2048] x [2048, 2048], max |cuda-cpu|: "
          f"{', '.join(line)}; a bfloat16-output product equals the float32 "
          f"one rounded: {torch.equal(direct, explicit)}")


# Substrings of the names of the device kernels that belong to a matrix
# product (cuBLAS's split-K reduction included).
PRODUCT_KEYS = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitK")


def is_fp32_product(name: str) -> bool:
    """A cuBLAS product outside the tensor cores: an SGEMM, or one of its
    matrix-vector kernels instantiated for float operands."""
    if "sgemm" in name:
        return True
    return (("gemv" in name or "gemmSN" in name)
            and "bf16" not in name and "bfloat16" not in name)


def decode_times(enh32: Enhancer, enh16: Enhancer, waves: list, label: str,
                 repeats: int = 5) -> None:
    """ms per batch of the device-only int16 decode, float32 beside
    bfloat16 in turns, by ``decode_fps``'s method; then each one's device
    busy time and the network's products' share of it."""
    x, n_valid, frames = pad_batch(waves, enh32.device)
    runs = {"float32": [], "bfloat16": []}
    for _ in range(repeats):
        for name, enh in (("float32", enh32), ("bfloat16", enh16)):
            runs[name].append(time_ms(
                lambda: enh.decode_waves_tensor(x, n_valid), iters=20))
    for name, enh in (("float32", enh32), ("bfloat16", enh16)):
        ms = sorted(runs[name])
        busy, launches, kernels = device_profile(
            lambda: enh.decode_waves_tensor(x, n_valid), 5)
        ffn = sum(us for k, us, _ in kernels
                  if any(key in k for key in PRODUCT_KEYS))
        print(f"bf16    decode {label} ({frames} frames, {x.shape[0]} "
              f"utterances) {name}: {ms[0]:.4f}-{ms[-1]:.4f} ms per batch "
              f"over {repeats} repeats, median {ms[repeats // 2]:.4f} ms = "
              f"{frames / ms[repeats // 2] * 1e3:.0f} frames/s; device busy "
              f"{busy:.1f} us over {launches:.0f} launches (idle "
              f"{1 - busy / (ms[repeats // 2] * 1e3):.1%}), products "
              f"{ffn:.1f} us = {ffn / busy:.1%} of busy")


def bf16_decode(dev, fx: dict) -> int:
    """``Enhancer(compute_dtype=torch.bfloat16)`` on the card: its kernels,
    its enhanced LPS against the CPU's, its time.  -> LPS kernel launches
    of the two batch decodes."""
    card = Enhancer(fx["wts"], fx["norm"], device=dev,
                    compute_dtype=torch.bfloat16)
    host = Enhancer(fx["wts"], fx["norm"], device="cpu",
                    compute_dtype=torch.bfloat16)
    card32 = Enhancer(fx["wts"], fx["norm"], device=dev)

    x, n_valid, _ = pad_batch(fx["waves"], dev)
    card.decode_waves_tensor(x, n_valid)                 # warm
    _, _, kernels = device_profile(
        lambda: card.decode_waves_tensor(x, n_valid), 3)
    products = [(k, us, n) for k, us, n in kernels
                if any(key in k for key in PRODUCT_KEYS)]
    for k, us, n in kernels[:14]:
        print(f"bf16    decode kernel {n:4.1f} x {k[:80]:80s} {us:8.1f} us")
    fp32 = [k for k, _, _ in products if is_fp32_product(k)]
    n_products = sum(n for _, _, n in products)
    n_layers = len(card.model.weights)
    print(f"bf16    decode: {n_products:.0f} product kernels per batch for "
          f"{n_layers} layers, {len(fp32)} of them float32 SGEMM/GEMV")
    if fp32 or n_products < n_layers:
        raise SystemExit(f"the bfloat16 decode's products: {products}")

    want = host.enhance_batch(fx["waves"])
    total = 0
    for label, waves in (("batch 4", fx["waves"]),
                         ("batch 16", fx["waves"] * 4)):
        lps_kernel.launches = 0
        got = card.enhance_batch(waves)
        torch.cuda.synchronize()
        launches = lps_kernel.launches
        total += launches
        plain = card32.enhance_batch(waves)
        worst = gap = scale = 0.0
        lsb_cpu = lsb_fp32 = 0
        for i, (g, p) in enumerate(zip(got, plain)):
            w = want[i % len(want)]
            if g[0].shape != w[0].shape or not np.isfinite(g[2]).all():
                raise SystemExit(f"bfloat16 decode {label}: utterance {i} "
                                 "has another length or is not finite")
            worst = max(worst, float(np.abs(g[2] - w[2]).max()))
            gap = max(gap, float(np.abs(g[2] - p[2]).max()))
            scale = max(scale, float(np.abs(w[2]).max()))
            lsb_cpu = max(lsb_cpu, wrapped_lsb(g[0], w[0]))
            lsb_fp32 = max(lsb_fp32, wrapped_lsb(g[0], p[0]))
        tol = BF16_NET_SHARE * gap
        print(f"bf16    decode {label}: {launches} LPS kernel launch; "
              f"enhanced LPS max |cuda-cpu| = {worst:.3e}, tolerance "
              f"{tol:.3e} = {BF16_NET_SHARE} x the card's float32 decode's "
              f"distance {gap:.3e} (max|LPS| {scale:.2f}); waves {lsb_cpu} "
              f"LSB from the CPU's, {lsb_fp32} LSB from the float32 "
              f"decode's (not gated)")
        if launches != 1 or not worst <= tol:
            raise SystemExit(f"bfloat16 decode {label}: {launches} LPS "
                             f"launches, {worst:.3e} from the CPU's")
        decode_times(card32, card, waves, label)
    return total


def bf16_stream(fx: dict, fp32_hops: dict) -> int:
    """``StreamingEnhancer(compute_dtype=torch.bfloat16)`` at each stream
    count: 64 hops replayed against eager (bitwise), then the replayed
    hop's launches, products and time beside float32's.  -> graph replays
    of the 64-hop runs (one LPS kernel launch each)."""
    total = 0
    for n in STREAM_COUNTS:
        hops = stream_hops(fx["waves"], n, 64)
        kw = {"n_streams": n, "compute_dtype": torch.bfloat16}
        replayed = StreamingEnhancer(fx["wts"], fx["norm"], **kw)
        eager = StreamingEnhancer(fx["wts"], fx["norm"], graph=False, **kw)
        outs = {}
        streaming.hops_replayed = 0
        for name, s in (("replayed", replayed), ("eager", eager)):
            outs[name] = np.concatenate(
                [s.push_many(hops[:, lo:lo + CHUNK_HOPS], int16_wire=True)[0]
                 for lo in range(0, hops.shape[1], CHUNK_HOPS)], axis=1)
        torch.cuda.synchronize()
        replays = streaming.hops_replayed
        total += replays
        same = np.array_equal(outs["replayed"], outs["eager"]) and all(
            torch.equal(a, b) for a, b in zip(replayed.state, eager.state))
        finite = all(bool(torch.isfinite(t).all()) for t in replayed.state)
        if not (same and finite and replays == hops.shape[1]):
            raise SystemExit(f"bfloat16 stream S={n}: replayed == eager "
                             f"{same}, finite {finite}, {replays} replays")
        with torch.inference_mode():
            replay_us = time_ms(replayed._run_step, iters=200) * 1e3
        prof = hop_profile(replayed, f"one replayed bfloat16 hop at S={n}")
        ref = fp32_hops[n]
        weights_mb = sum(w.numel() * w.element_size() for w in
                         replayed._step_args.cast_weights) / 1e6
        print(f"bf16    stream S={n:3d}: 64 hops replayed == eager bitwise "
              f"(outputs and state); replayed hop {replay_us:.1f} us "
              f"(float32 {ref['replay_us']:.1f}), {prof['launches']:.0f} "
              f"device launches ({ref['launches']:.0f}), products "
              f"{prof['ffn_us']:.1f} us ({ref['ffn_us']:.1f}) over "
              f"{weights_mb:.1f} MB of weights = "
              f"{weights_mb / prof["ffn_us"]:.2f} TB/s at least")
    return total


def big_bunch_ms(dev, tfx: dict, init_wts: str) -> None:
    """Informational: ms per bunch at M = BIG_BUNCH, float32 beside
    bfloat16 in turns, host clock around 4 bunches ending in a synchronise
    (``train_rate``'s method).  The fixtures hold fewer windows than one
    such bunch, so the windows are drawn with replacement from the
    resident frames."""
    ds = PfilePairDataset(tfx["noisy"], tfx["clean"], tfx["norm"],
                          tuple(int(x) for x in tfx["train_sents"].split("-")),
                          tfx["traincache"])
    noisy, clean = load_device_frames(ds, dev)
    rng = np.random.default_rng(SEED)
    starts = torch.from_numpy(rng.integers(
        0, noisy.shape[0] - 7, size=(5, BIG_BUNCH))).to(dev)
    ms = {"float32": [], "bfloat16": []}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        hyper = TrainHyper(bunchsize=BIG_BUNCH, compute_dtype=name)
        state = load_checkpoint(init_wts, dev)
        train_chunk(state, noisy, clean, starts[:1], float(AGREE_LRATE),
                    hyper)                                   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_chunk(state, noisy, clean, starts[1:], float(AGREE_LRATE),
                    hyper)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / 4)
        if not all(bool(torch.isfinite(w).all())
                   for w in state.model.weights):
            raise SystemExit(f"M={BIG_BUNCH} {name} bunches left weights "
                             "that are not finite")
    print(f"bf16    train M={BIG_BUNCH}, 4 bunches, ms per bunch: " + "; ".join(
        f"{name} {', '.join(f'{t:.3f}' for t in ts)} "
        f"({BIG_BUNCH / min(ts) * 1e3:.0f} samples/s at best)"
        for name, ts in ms.items()))
    # Where a bunch's device time goes, at the parity bunch and this one.
    for m in (BUNCH, BIG_BUNCH):
        for name in ("float32", "bfloat16"):
            hyper = TrainHyper(bunchsize=m, compute_dtype=name)
            state = load_checkpoint(init_wts, dev)
            rows = starts[:1, :m]
            # Eager: a replayed bunch's kernels, and no graph under the
            # tracer in this process (GRAPH_CHILD).
            busy, launches, kernels = device_profile(
                lambda: train_chunk(state, noisy, clean, rows,
                                    float(AGREE_LRATE), hyper, graph=False),
                3)
            products = sum(us for k, us, _ in kernels
                           if any(key in k for key in PRODUCT_KEYS))
            casts = sum(us for k, us, _ in kernels if "bfloat16_copy" in k)
            top, top_us, top_n = kernels[0]
            print(f"bf16    train bunch M={m} {name} (torch.profiler, 3 "
                  f"eager bunches): {launches:.0f} device launches, busy "
                  f"{busy:.1f} us: products {products:.1f}, casts to "
                  f"bfloat16 {casts:.1f}, the rest "
                  f"{busy - products - casts:.1f}; largest: {top_n:.0f} x "
                  f"{top[:72]} {top_us:.1f} us")


def bf16_train(dev, root: str, tfx: dict, init_wts: str) -> int:
    """``train --compute-dtype bfloat16`` and ``bptrain
    compute_dtype=bfloat16`` on the card.  -> GGD kernel launches."""
    flag = ("--compute-dtype", "bfloat16")
    want = ml_bunches(tfx)
    zero_train_counts()
    run_train(tfx, init_wts, os.path.join(root, "cuda"), "cuda", *flag)
    torch.cuda.synchronize()
    launches = ggd_kernel.launches
    replays = replay_check("train --compute-dtype bfloat16", want * EPOCHS)
    run_train(tfx, init_wts, os.path.join(root, "cuda2"), "cuda", *flag)
    names = [f"mlp.{e}.wts" for e in range(1, EPOCHS + 1)]

    def same(a: str, b: str, name: str) -> bool:
        with open(os.path.join(root, a, name), "rb") as f1, \
                open(os.path.join(root, b, name), "rb") as f2:
            return f1.read() == f2.read()

    rerun = all(same("cuda", "cuda2", name) for name in names)
    with open(os.path.join(root, "cuda", "mlp.1.log")) as f:
        logged = "compute_dtype = bfloat16" in f.read()
    os.makedirs(os.path.join(root, "bptrain"))
    zero_train_counts()
    cli(["bptrain", *finetune_args(tfx, init_wts,
                                   os.path.join(root, "bptrain"), 1,
                                   "compute_dtype=bfloat16")])
    torch.cuda.synchronize()
    chain = same("cuda", "bptrain", "mlp.1.wts")
    print(f"bf16    train --compute-dtype bfloat16 on the card: "
          f"ggd_kernel.launches = {launches} for {want * EPOCHS} ML bunches "
          f"({replays}); second run byte-identical = {rerun}; bptrain "
          f"compute_dtype=bfloat16 epoch 1 byte-identical to train's = "
          f"{chain}, {ggd_kernel.launches} launches for {want} bunches "
          f"({replay_check('bptrain compute_dtype=bfloat16', want)})")
    if not (launches == want * EPOCHS and ggd_kernel.launches == want
            and rerun and chain and logged):
        raise SystemExit("bfloat16 training on the card: launches, reruns, "
                         "the bptrain epoch or the log's config line are off")
    launches += ggd_kernel.launches
    with open(os.path.join(root, "cuda", "mlp.2.wts"), "rb") as f1, \
            open(os.path.join(os.path.dirname(root), "cuda", "mlp.2.wts"),
                 "rb") as f2:
        if f1.read() == f2.read():
            raise SystemExit("bfloat16 training wrote the float32 run's bytes")

    lr = ("--lrate", AGREE_LRATE)
    cuda_rec = run_train(tfx, init_wts, os.path.join(root, "cuda_lr"),
                         "cuda", *flag, *lr)
    t0 = time.perf_counter()
    cpu_rec = run_train(tfx, init_wts, os.path.join(root, "cpu_lr"), "cpu",
                        *flag, *lr)
    cpu_s = time.perf_counter() - t0
    w0 = read_wts(init_wts)
    w_cuda = read_wts(os.path.join(root, "cuda_lr", "mlp.2.wts"))
    w_cpu = read_wts(os.path.join(root, "cpu_lr", "mlp.2.wts"))
    rels = []
    for a, g, c in zip(w0, w_cuda, w_cpu):
        for k in ("w", "b"):
            d_cuda = g[k].astype(np.float64) - a[k]
            d_cpu = c[k].astype(np.float64) - a[k]
            rels.append(np.linalg.norm(d_cuda - d_cpu)
                        / np.linalg.norm(d_cpu))
    worst_cv = max(abs(rc[k] - rp[k]) / abs(rp[k])
                   for rc, rp in zip(cuda_rec, cpu_rec)
                   for k in ("cv_squared_error", "cv_abs_error",
                             "cv_ggd_loglik"))
    print(f"bf16    train at lrate {AGREE_LRATE}, card against CPU (CPU "
          f"{cpu_s:.2f} s): |dW_cuda - dW_cpu| / |dW_cpu| per layer (w, b) = "
          f"{', '.join(f'{r:.3e}' for r in rels)} (tolerance "
          f"{BF16_TRAIN_DW_RTOL}); CV metrics within {worst_cv:.3e} "
          f"(tolerance {BF16_TRAIN_CV_RTOL})")
    if not (max(rels) <= BF16_TRAIN_DW_RTOL
            and worst_cv <= BF16_TRAIN_CV_RTOL):
        raise SystemExit("bfloat16 training on the card is off the CPU's")

    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        train_rate(dev, tfx, init_wts, compute_dtype=name)
    big_bunch_ms(dev, tfx, init_wts)
    return launches


def bf16_extras(dev, root: str, fx: dict, tfx: dict, init_wts: str) -> None:
    """``wav_to_mfcc`` on the card against the CPU, and one training bunch
    under ``profile_trace``."""
    got = wav_to_mfcc(fx["waves"][1], device=dev)
    want = wav_to_mfcc(fx["waves"][1], device="cpu")
    err = float(np.abs(got - want).max())
    print(f"bf16    wav_to_mfcc: {got.shape} cepstra, max |cuda-cpu| = "
          f"{err:.3e} (tolerance {MFCC_ATOL})")
    if (got.shape != (len(fx["waves"][1]) // SHIFT - 1, 13)
            or got.dtype != np.float32 or not err <= MFCC_ATOL):
        raise SystemExit("wav_to_mfcc on the card is off the CPU's")

    ds = PfilePairDataset(tfx["noisy"], tfx["clean"], tfx["norm"],
                          tuple(int(x) for x in tfx["train_sents"].split("-")),
                          tfx["traincache"])
    noisy, clean = load_device_frames(ds, dev)
    starts = torch.arange(BUNCH, device=dev)[None]
    hyper = TrainHyper(compute_dtype="bfloat16")
    state = load_checkpoint(init_wts, dev)
    # Eager bunches (graph=False): no graph under the tracer in this
    # process (GRAPH_CHILD).
    train_chunk(state, noisy, clean, starts, float(AGREE_LRATE), hyper,
                graph=False)
    # The tracer now and then loses a window's device records (see
    # ``device_profile``): a bunch launches the same kernels every time, so
    # a fault of ``profile_trace`` shows in every trace, a lost record in one.
    for attempt in range(TRACE_WINDOWS):
        log_dir = os.path.join(root, f"trace{attempt}")
        torch.cuda.synchronize()
        with profile_trace(log_dir):
            train_chunk(state, noisy, clean, starts, float(AGREE_LRATE),
                        hyper, graph=False)
            torch.cuda.synchronize()
        files = [f for f in os.listdir(log_dir)
                 if f.endswith(".pt.trace.json")]
        if len(files) != 1:
            raise SystemExit(f"profile_trace left {files} in {log_dir}")
        with open(os.path.join(log_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        ggd = sum("ggd" in name for name in kernels)
        if kernels and ggd == 1:
            break
        print(f"bf16    profile_trace of one bfloat16 bunch: {len(kernels)} "
              f"CUDA kernels, {ggd} of them the GGD kernel (trace "
              f"{attempt + 1} of {TRACE_WINDOWS}); traced again")
    size = os.path.getsize(os.path.join(log_dir, files[0]))
    print(f"bf16    profile_trace of one bfloat16 bunch: {files[0]}, {size} "
          f"bytes, {len(kernels)} CUDA kernels in it, {ggd} of them the GGD "
          f"kernel")
    if not kernels or ggd != 1:
        raise SystemExit("the trace holds no CUDA kernels, or not one GGD "
                         "kernel")


def bf16_phase(dev, root: str, fx: dict, train: dict, fp32_hops: dict
               ) -> dict:
    """-> the phase's LPS and GGD kernel launches."""
    t0 = time.perf_counter()
    os.makedirs(root)
    bf16_forward(dev, fx)
    lps_launches = bf16_decode(dev, fx)
    lps_launches += bf16_stream(fx, fp32_hops)
    ggd_launches = bf16_train(dev, root, train["tfx"], train["init_wts"])
    bf16_extras(dev, root, fx, train["tfx"], train["init_wts"])
    print(f"bf16    bfloat16 phase wall time: "
          f"{time.perf_counter() - t0:.2f} s")
    return {"lps_launches": lps_launches, "ggd_launches": ggd_launches}


def split_bound_ms(m: int, d: int) -> tuple[float, float]:
    """The least the card could take for the two split launches on [m, d]
    rows: ``ggd_colsum`` reads out and targ and writes the sums;
    ``ggd_grad_from_sums`` reads out, targ and the sums and writes dedx and
    alpha; both at the memory rate."""
    return (4 * (2 * m * d + d) / HBM_BYTES_PER_S * 1e3,
            4 * (3 * m * d + 2 * d) / HBM_BYTES_PER_S * 1e3)


def split_kernel_phase(dev) -> dict:
    """The split GGD kernels against their plain versions, the fused kernel
    and each other; their device times.  -> the kernel table's numbers."""
    rng = np.random.default_rng(SEED + 11)
    lib, _ = load_library()
    d = 257
    max_abs = {"colsum": 0.0, "from_sums": 0.0}
    for m in SPLIT_ROWS:
        out_np, targ_np = ggd_inputs(rng, m, d)
        out = torch.from_numpy(out_np).to(dev)
        targ = torch.from_numpy(targ_np).to(dev)
        errs = []
        for beta in SPLIT_BETAS:
            sums = ggd_kernel.ggd_colsum_cuda(out, targ, beta)
            sums2 = ggd_kernel.ggd_colsum_cuda(out, targ, beta)
            dedx, alpha = ggd_kernel.ggd_grad_from_sums_cuda(out, targ, sums,
                                                             m, beta)
            dedx2, alpha2 = ggd_kernel.ggd_grad_from_sums_cuda(
                out, targ, sums, m, beta)
            want_s = ggd_kernel.ggd_colsum_plain(out, targ, beta)
            want_d, want_a = ggd_kernel.ggd_grad_from_sums_plain(
                out, targ, sums, m, beta)
            fused_d, fused_a = ggd_kernel.ggd_output_grad_cuda(out, targ,
                                                               beta)
            torch.cuda.synchronize()
            rel = max(max_rel(sums, want_s), max_rel(dedx, want_d),
                      max_rel(alpha, want_a))
            zeros = (bool((dedx[2::5] == 0).all())
                     and bool((dedx[:, d // 2] == 0).all())
                     and alpha[d // 2].item() == 0.0
                     and sums[d // 2].item() == 0.0)
            same = (torch.equal(sums, sums2) and torch.equal(dedx, dedx2)
                    and torch.equal(alpha, alpha2))
            as_fused = (torch.equal(dedx, fused_d)
                        and torch.equal(alpha, fused_a))
            if not (rel <= GGD_RTOL and zeros and same and as_fused):
                raise SystemExit(
                    f"split GGD kernels disagree at M={m} beta={beta}: max "
                    f"rel {rel:.3e}, exact zeros {zeros}, rerun bitwise "
                    f"{same}, bitwise the fused kernel {as_fused}")
            errs.append(rel)
            max_abs["colsum"] = max(max_abs["colsum"],
                                    (sums - want_s).abs().max().item())
            max_abs["from_sums"] = max(max_abs["from_sums"],
                                       (dedx - want_d).abs().max().item(),
                                       (alpha - want_a).abs().max().item())
            # Two ranks' halves: their sums added give the bunch's alpha.
            half = m // 2
            both = (ggd_kernel.ggd_colsum_cuda(out[:half], targ[:half], beta)
                    + ggd_kernel.ggd_colsum_cuda(out[half:], targ[half:],
                                                 beta))
            halves = [ggd_kernel.ggd_grad_from_sums_cuda(
                out[lo:lo + half], targ[lo:lo + half], both, m, beta)
                for lo in (0, half)]
            torch.cuda.synchronize()
            rel2 = max(max_rel(halves[0][1], fused_a),
                       max_rel(torch.cat([h[0] for h in halves]), fused_d))
            if not (rel2 <= GGD_RTOL
                    and torch.equal(halves[0][1], halves[1][1])):
                raise SystemExit(
                    f"two half-bunches disagree with the bunch at M={m} "
                    f"beta={beta}: max rel {rel2:.3e}")
            errs.append(rel2)
        print(f"dp      M={m:5d} D={d}: split kernels, max rel |cuda-plain| "
              f"and |two halves - whole| over beta {SPLIT_BETAS} = "
              f"{', '.join(f'{e:.2e}' for e in errs)}; zeros exact, reruns "
              f"bitwise equal, one rank bitwise equal to the fused kernel")

    times = {}
    for m in (64, 128):
        out_np, targ_np = ggd_inputs(rng, m, d)
        out = torch.from_numpy(out_np).to(dev)
        targ = torch.from_numpy(targ_np).to(dev)
        sums = ggd_kernel.ggd_colsum_cuda(out, targ, 1.0)

        def colsum():
            return ggd_kernel.ggd_colsum_cuda(out, targ, 1.0)

        def from_sums():
            return ggd_kernel.ggd_grad_from_sums_cuda(out, targ, sums, m, 1.0)

        def colsum_plain():
            return ggd_kernel.ggd_colsum_plain(out, targ, 1.0)

        def from_sums_plain():
            return ggd_kernel.ggd_grad_from_sums_plain(out, targ, sums, m,
                                                       1.0)

        def fused():
            return ggd_kernel.ggd_output_grad_cuda(out, targ, 1.0)

        def empty():
            lib.ggd_launch_floor(m, d,
                                 torch.cuda.current_stream().cuda_stream)

        us = {name: device_us(fn) for name, fn in (
            ("colsum", colsum), ("from_sums", from_sums),
            ("colsum_plain", colsum_plain),
            ("from_sums_plain", from_sums_plain), ("fused", fused),
            ("empty", empty))}
        bound = split_bound_ms(m, d)
        times[m] = {
            "colsum": {"ms": us["colsum"] / 1e3,
                       "plain_ms": us["colsum_plain"] / 1e3,
                       "bound_ms": bound[0], "bound_by": "bytes"},
            "from_sums": {"ms": us["from_sums"] / 1e3,
                          "plain_ms": us["from_sums_plain"] / 1e3,
                          "bound_ms": bound[1], "bound_by": "bytes"}}
        print(f"dp      M={m:5d} D={d} beta=1: device time ggd_colsum "
              f"{us['colsum']:.2f} us (plain {us['colsum_plain']:.2f}, bound "
              f"{bound[0] * 1e3:.2f} us, bytes), ggd_grad_from_sums "
              f"{us['from_sums']:.2f} us (plain {us['from_sums_plain']:.2f}, "
              f"bound {bound[1] * 1e3:.2f} us, bytes); the fused kernel "
              f"{us['fused']:.2f} us, an empty kernel launched the same way "
              f"{us['empty']:.2f} us")
    return {"max_abs_err": max_abs, "times": times}


def visible_cards() -> list[str]:
    """This process's cards as ``CUDA_VISIBLE_DEVICES`` names them (their
    indices when it is not set), in this process's order."""
    named = os.environ.get("CUDA_VISIBLE_DEVICES")
    if named is None:
        return [str(k) for k in range(torch.cuda.device_count())]
    return [c.strip() for c in named.split(",")
            if c.strip()][:torch.cuda.device_count()]


def start_rank(argv: list, log_path: str, cards: tuple = (0,)) -> dict:
    """Start ``python <argv>`` from the checkout, its output in a file,
    seeing only ``cards`` (indices into this process's cards, in that
    order): card 0 alone, as on a one-card machine, unless a phase spreads
    its ranks over cards."""
    names = visible_cards()
    env = dict(os.environ,
               CUDA_VISIBLE_DEVICES=",".join(names[k] for k in cards))
    log = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, *argv], cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT, env=env)
    return {"proc": proc, "log": log, "path": log_path, "argv": argv}


def wait_ranks(ranks: list, label: str, want_ok: bool = True) -> list[str]:
    """Wait for child ranks -> their outputs.  They share
    ``RANKS_TIMEOUT_S``; on a timeout, or an exit code that is (``want_ok``)
    not 0 or (otherwise) 0, every child is killed and the smoke ends with
    all their output."""
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    fault = ""
    for r in ranks:
        try:
            r["proc"].wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            fault = f"{label}: no end after {RANKS_TIMEOUT_S} s"
            break
    for r in ranks:
        if r["proc"].poll() is None:
            r["proc"].kill()
            r["proc"].wait()
        r["log"].close()
    outputs = []
    for r in ranks:
        with open(r["path"]) as f:
            outputs.append(f.read())
    codes = [r["proc"].returncode for r in ranks]
    if not fault and any((code == 0) != want_ok for code in codes):
        fault = (f"{label}: exit codes {codes}, wanted "
                 f"{'0' if want_ok else 'a failure'} from each")
    if fault:
        for r, text in zip(ranks, outputs):
            print(f"---- {' '.join(r['argv'][:6])} ...\n{text}")
        raise SystemExit(fault)
    return outputs


def train_rank_argv(tfx: dict, init_wts: str, out_dir: str, *extra) -> list:
    return ["-m", "tpu_se_torch", "train", "--fea-file", tfx["noisy"],
            "--targ-file", tfx["clean"], "--norm-file", tfx["norm"],
            "--init-wts", init_wts, "--out-dir", out_dir,
            "--train-sents", tfx["train_sents"],
            "--cv-sents", tfx["cv_sents"],
            "--traincache", str(tfx["traincache"]),
            "--epochs", str(EPOCHS), "--device", "cuda", *extra]


def coordinator_flags(port: int, n_ranks: int, rank: int, gloo: bool) -> list:
    return ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
            str(n_ranks), "--process-id", str(rank),
            *(["--cpu-collectives", "gloo"] if gloo else [])]


MESH_LINE = re.compile(
    r"data mesh: rank (\d+) of (\d+) \((\w+)\): ggd_colsum (\d+) launches, "
    r"ggd_grad_from_sums (\d+) launches, sgd_momentum_update (\d+) "
    r"launches, data axis all_reduce (\d+) calls "
    r"(\d+) bytes all_gather (\d+) calls (\d+) bytes; model axis all_reduce "
    r"(\d+) calls (\d+) bytes all_gather (\d+) calls (\d+) bytes, replicas "
    r"equal at (\d+) epoch ends; (\d+) bunches replayed after (\d+) "
    r"captures")


def mesh_summary(output: str, label: str) -> dict:
    """The numbers of a rank's closing ``data mesh:`` line: its split GGD
    and optimizer kernel launches, what its collectives moved over each
    axis (``calls`` and ``bytes`` are the data axis' all-reduces), and its
    bunches replayed and graphs captured."""
    found = MESH_LINE.search(output)
    if not found:
        raise SystemExit(f"{label}: no closing 'data mesh:' line in\n{output}")
    keys = ("rank", "ranks", "backend", "colsum", "from_sums", "sgd", "calls",
            "bytes", "data_gathers", "data_gather_bytes", "model_calls",
            "model_bytes", "model_gathers", "model_gather_bytes",
            "replica_checks", "replayed", "captured")
    return {k: v if k == "backend" else int(v)
            for k, v in zip(keys, found.groups())}


def mesh_replays(got: dict, bunches: int, label: str) -> str:
    """Require that an NCCL rank replayed every bunch of its ``bunches``
    but one eager warm-up per capture, and a gloo rank none. -> a line's
    worth of both counts."""
    replayed, captured = got["replayed"], got["captured"]
    if got["backend"] == "nccl":
        ok = captured >= 1 and replayed == bunches - captured
    else:
        ok = replayed == captured == 0
    if not ok:
        raise SystemExit(f"{label} ({got['backend']}): {replayed} bunches "
                         f"replayed after {captured} captures for {bunches} "
                         "bunches")
    return f"{replayed} replayed + {captured} warm-up bunches"


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def dp_train_runs(root: str, train: dict) -> dict:
    """One rank over NCCL, two ranks over gloo (twice), and the refusals,
    all as child processes, started together.  -> the split kernels'
    launches on these paths."""
    tfx, init_wts = train["tfx"], train["init_wts"]
    bunches = ml_bunches(tfx) * EPOCHS
    n_params = sum(layer["w"].size + layer["b"].size
                   for layer in read_wts(init_wts))
    lr = ("--lrate", AGREE_LRATE)

    def log(name):
        return os.path.join(root, f"{name}.log")

    nccl1 = [start_rank(train_rank_argv(
        tfx, init_wts, os.path.join(root, "nccl1"),
        *coordinator_flags(free_port(), 1, 0, False)), log("nccl1"))]
    nccl1_dropout = [start_rank(train_rank_argv(
        tfx, init_wts, os.path.join(root, "nccl1_dropout"), "--dropoutflag",
        "1", *coordinator_flags(free_port(), 1, 0, False)),
        log("nccl1_dropout"))]
    gloo = {}
    for name in ("gloo2", "gloo2_again"):
        port = free_port()
        gloo[name] = [start_rank(train_rank_argv(
            tfx, init_wts, os.path.join(root, name), *lr,
            *coordinator_flags(port, 2, k, True)), log(f"{name}.{k}"))
            for k in (0, 1)]
    port = free_port()
    refusals = {
        "--mesh-data 2 on one card": (
            [start_rank(train_rank_argv(
                tfx, init_wts, os.path.join(root, "refused_mesh"),
                "--mesh-data", "2"), log("refused_mesh"))],
            "mesh 2x1 needs 2 devices, have 1"),
        "NCCL with two ranks on one card": (
            [start_rank(train_rank_argv(
                tfx, init_wts, os.path.join(root, "refused_nccl"),
                *coordinator_flags(port, 2, k, False)),
                log(f"refused_nccl.{k}")) for k in (0, 1)],
            "NCCL needs one card per rank"),
        "--mesh-model 2 on one card": (
            [start_rank(train_rank_argv(
                tfx, init_wts, os.path.join(root, "refused_model"),
                "--mesh-model", "2"), log("refused_model"))],
            "mesh 1x2 needs 2 devices, have 1"),
        "--mesh-model 3 (a width of 2048)": (
            [start_rank(train_rank_argv(
                tfx, init_wts, os.path.join(root, "refused_width"),
                "--mesh-model", "3"), log("refused_width"))],
            "hidden width 2048 does not split evenly over 3 ranks"),
    }

    # 1 rank over NCCL, a 1x1 mesh: the mesh's step (split GGD kernels,
    # collectives, the model as a TensorParallelFFN with one rank on its
    # model axis) with one device's bits.
    out = wait_ranks(nccl1, "1 rank over NCCL")[0]
    got = mesh_summary(out, "1 rank over NCCL")
    identical = same_bytes(os.path.join(root, "nccl1", "mlp.2.wts"),
                           os.path.join(root, "cuda", "mlp.2.wts"))
    if "data mesh: data=1, model=1, rank 0 on cuda:0 (nccl)" not in out:
        raise SystemExit(f"1 rank over NCCL: no 1x1 mesh line in\n{out}")
    print(f"dp      1 rank over NCCL (1x1 mesh, TensorParallelFFN): "
          f"ggd_colsum {got['colsum']} and "
          f"ggd_grad_from_sums {got['from_sums']} launches for {bunches} ML "
          f"bunches ({mesh_replays(got, bunches, '1 rank over NCCL')}), "
          f"all_reduce {got['calls']} calls {got['bytes']} bytes, "
          f"replicas checked at {got['replica_checks']} epoch ends; mlp.2.wts "
          f"byte-identical to the single-process run = {identical}")
    want_bytes = bunches * 4 * (257 + n_params)
    if not (got["backend"] == "nccl" and got["ranks"] == 1
            and got["colsum"] == got["from_sums"] == got["sgd"] == bunches
            and got["calls"] == 2 * bunches and got["bytes"] == want_bytes
            and got["replica_checks"] == EPOCHS and identical):
        raise SystemExit(f"1 rank over NCCL: {got}, wanted {bunches} "
                         f"launches of each, {2 * bunches} collectives of "
                         f"{want_bytes} bytes and the single-process bytes")
    launches = {k: got[k] for k in ("colsum", "from_sums", "sgd")}

    # The same rank with dropout masks: drawn inside its replayed bunches
    # (the whole bunch's from the shared seed), the one process's bytes.
    out = wait_ranks(nccl1_dropout, "1 rank over NCCL, dropout")[0]
    got = mesh_summary(out, "1 rank over NCCL, dropout")
    identical = same_bytes(os.path.join(root, "nccl1_dropout", "mlp.2.wts"),
                           os.path.join(root, "dropout", "mlp.2.wts"))
    print(f"dp      1 rank over NCCL, --dropoutflag 1: "
          f"{mesh_replays(got, bunches, '1 rank over NCCL, dropout')}; "
          f"split GGD {got['colsum']} + {got['from_sums']}, optimizer "
          f"{got['sgd']} launches for {bunches} ML bunches; mlp.2.wts "
          f"byte-identical to the single-process dropout run = {identical}")
    if not (got["colsum"] == got["from_sums"] == got["sgd"] == bunches
            and got["calls"] == 2 * bunches and identical):
        raise SystemExit(f"1 rank over NCCL, dropout: {got}, identical "
                         f"{identical}")
    for key in launches:
        launches[key] += got[key]

    # 2 ranks sharing the card over gloo, lrate 0.001, twice.
    for name, ranks in gloo.items():
        outs = wait_ranks(ranks, f"2 ranks over gloo ({name})")
        for k, text in enumerate(outs):
            got = mesh_summary(text, f"{name} rank {k}")
            mesh_replays(got, bunches, f"{name} rank {k}")
            if not (got["backend"] == "gloo" and got["ranks"] == 2
                    and got["rank"] == k
                    and got["colsum"] == got["from_sums"] == got["sgd"]
                    == bunches and got["calls"] == 2 * bunches
                    and got["replica_checks"] == EPOCHS):
                raise SystemExit(f"{name} rank {k}: {got}")
            for key in launches:
                launches[key] += got[key]
        rank0_files(os.path.join(root, name), name)
    again = same_bytes(os.path.join(root, "gloo2", "mlp.2.wts"),
                       os.path.join(root, "gloo2_again", "mlp.2.wts"))
    w0 = read_wts(init_wts)
    w_one = read_wts(os.path.join(root, "cuda_lr", "mlp.2.wts"))
    w_two = read_wts(os.path.join(root, "gloo2", "mlp.2.wts"))
    worst = 0.0
    for i, (a, one, two) in enumerate(zip(w0, w_one, w_two)):
        for k in ("w", "b"):
            d_one = one[k].astype(np.float64) - a[k]
            d_two = two[k].astype(np.float64) - a[k]
            rel = np.linalg.norm(d_two - d_one) / np.linalg.norm(d_one)
            print(f"dp      2 ranks over gloo, lrate {AGREE_LRATE} layer {i} "
                  f"{k}: |dW_2 - dW_1| / |dW_1| = {rel:.3e}")
            worst = max(worst, rel)
    print(f"dp      2 ranks over gloo: every rank's replica check passed at "
          f"{EPOCHS} epoch ends, only rank 0's files on disk, second run "
          f"byte-identical = {again}, weight changes within {worst:.3e} of "
          f"the one-process card run")
    if not (again and worst <= TRAIN_DW_RTOL):
        raise SystemExit(f"2 ranks over gloo: rerun identical {again}, "
                         f"weight changes {worst:.3e} from one process")

    for label, (ranks, message) in refusals.items():
        outs = wait_ranks(ranks, label, want_ok=False)
        if not all(message in text for text in outs):
            for text in outs:
                print(text)
            raise SystemExit(f"{label}: refused without {message!r}")
        print(f"dp      refused, {label}: '{message}'")
    return launches


def against_eager(r: dict, label: str) -> str:
    """A ``bench/dp_epoch --against-eager`` rank's record: its replayed
    state must be its eager one's bit for bit, the two timed epochs' launches
    and collectives equal, the timed replayed epoch all replays and the
    eager one none.  -> a line's worth of times and counts."""
    e = r["eager"]
    if not (e["bitwise"] and e["counts_equal"] and e["bunches_replayed"] == 0
            and r["bunches_replayed"] == r["bunches"]
            and r["graphs_captured"] == 0):
        raise SystemExit(f"{label}: the replayed bunches against the eager "
                         f"loop (largest difference {e['max_abs_diff']:.3e}): "
                         f"{r}")
    return (f"replayed {' / '.join(f'{t:.4f}' for t in e['replayed_ms_per_bunch'])}"
            f" ms per bunch, eager "
            f"{' / '.join(f'{t:.4f}' for t in e['ms_per_bunch'])} (epochs 2 "
            f"and 3 in turns), bitwise equal, launches and collectives "
            f"equal, {r['bunches_replayed']} of {r['bunches']} bunches "
            f"replayed")


def dp_epoch_times(root: str, train: dict) -> None:
    """ms per bunch for one rank fused, one rank over NCCL (split; replayed
    and held to its eager loop, ``against_eager``) and two ranks over gloo
    (eager), one cluster at a time, through ``python -m
    tpu_se_torch.bench.dp_epoch``; and the gathered span.  The one-rank
    forms are compared in turns inside one process by the benches phase
    (``bench/scaling.py``); here each runs once."""
    tfx, init_wts = train["tfx"], train["init_wts"]
    base = ["-m", "tpu_se_torch.bench.dp_epoch", "--fea-file", tfx["noisy"],
            "--targ-file", tfx["clean"], "--norm-file", tfx["norm"],
            "--init-wts", init_wts, "--train-sents", tfx["train_sents"],
            "--traincache", str(tfx["traincache"]), "--device", "cuda"]
    for label, n_ranks, gloo in (
            ("1 rank, fused kernel, no group", 0, False),
            ("1 rank over NCCL, split kernels", 1, False),
            ("2 ranks over gloo, split kernels", 2, True)):
        port = free_port()
        nccl = n_ranks and not gloo
        ranks = [start_rank(
            base + (coordinator_flags(port, n_ranks, k, gloo)
                    if n_ranks else [])
            + (["--against-eager"] if nccl else []),
            os.path.join(root, f"dp_epoch.{n_ranks}.{k}.log"))
            for k in range(max(1, n_ranks))]
        for text in wait_ranks(ranks, f"dp_epoch, {label}"):
            r = json.loads(text.strip().splitlines()[-1])
            per_call = (r["all_reduce_bytes"] // r["all_reduce_calls"] * 2
                        if r["all_reduce_calls"] else 0)
            held = (against_eager(r, f"dp_epoch, {label}") if nccl else
                    f"{r['bunches_replayed']} bunches replayed")
            print(f"dp      {label}, rank {r['rank']}: {r['ms_per_bunch']:.3f}"
                  f" ms per bunch over {r['bunches']} bunches of "
                  f"{r['rows_per_rank']} rows per rank; {held}; launches fused "
                  f"{r['ggd_output_grad_launches']}, ggd_colsum "
                  f"{r['ggd_colsum_launches']}, ggd_grad_from_sums "
                  f"{r['ggd_grad_from_sums_launches']}; all_reduce "
                  f"{r['all_reduce_calls']} calls, {r['all_reduce_bytes']} "
                  f"bytes ({per_call} per bunch: 1028 of column sums, the "
                  f"rest gradients); gathered span equal to the unsharded "
                  f"one = {r['span_equal']}")
            if not r["span_equal"]:
                raise SystemExit(f"dp_epoch, {label}: the gathered span "
                                 "differs from the unsharded read")
            if gloo and r["bunches_replayed"]:
                raise SystemExit(f"dp_epoch, {label}: a gloo rank replayed")
            split = r["bunches"] if n_ranks else 0
            if (r["ggd_colsum_launches"], r["ggd_grad_from_sums_launches"],
                    r["ggd_output_grad_launches"]) != (
                        split, split, r["bunches"] - split):
                raise SystemExit(f"dp_epoch, {label}: launches {r}")


def dp_phase(dev, root: str, train: dict) -> dict:
    """-> the split kernels' table numbers and launches."""
    t0 = time.perf_counter()
    os.makedirs(root)
    split = split_kernel_phase(dev)
    # The training phase's outputs that the ranks are held to.
    for name in ("cuda", "cuda_lr", "dropout"):
        os.symlink(os.path.join(os.path.dirname(root), name),
                   os.path.join(root, name))
    split["launches"] = dp_train_runs(root, train)
    dp_epoch_times(root, train)
    print(f"dp      data-parallel phase wall time: "
          f"{time.perf_counter() - t0:.2f} s")
    return split


def cv_batches(tfx: dict) -> int:
    """CV batches one epoch's CV takes (each runs the sharded forward)."""
    return sum(-(-n // CV_BATCH) for n in cv_windows(tfx))


def cv_windows(tfx: dict) -> list[int]:
    """Windows of each chunk of one epoch's CV (every rank runs them all)."""
    lo, hi = (int(x) for x in tfx["cv_sents"].split("-"))
    ds = PfilePairDataset(tfx["noisy"], tfx["clean"], tfx["norm"], (lo, hi),
                          tfx["traincache"])
    return [len(ds.chunk_starts(ci)) for ci in range(ds.n_chunks)]


def shard_floats(init_wts: str, model: int) -> tuple[int, int, int]:
    """-> (floats of one rank's parameters on a model axis of ``model``
    ranks: its gradients, all-reduced over the data axis in one buffer;
    the tensors that are split, each gathered when rank 0 writes; the
    floats of one rank's blocks of them)."""
    layers = read_wts(init_wts)
    specs = param_shardings(MeshConfig(1, model), len(layers))
    split = [(layer[k].size, "model" in spec[k])
             for layer, spec in zip(layers, specs) for k in ("w", "b")]
    return (sum(n // model if cut else n for n, cut in split),
            sum(cut for _, cut in split),
            sum(n // model for n, cut in split if cut))


def tp_want(tfx: dict, init_wts: str, data: int, model: int, k: int,
            backend: str) -> dict:
    """What rank ``k`` of a ``data`` x ``model`` mesh (model > 1) must
    report in its closing ``data mesh:`` line after ``EPOCHS`` epochs of
    the CLI's training on ``tfx`` from the full-width ``init_wts``.

    Per bunch: the data axis sums the GGD column sums and the gradients
    (data > 1 only); the model axis sums layer 1's partial z and layer 2's
    input gradient ([M/D, width] float32 each) and gathers layer 2's
    columns ([M/D, width/model] from each rank); each CV batch runs the
    sharded forward of all its rows (1 sum, 1 gather), and at each epoch's
    end the ranks of data index 0 gather every split tensor for rank 0 to
    write."""
    bunches = ml_bunches(tfx) * EPOCHS
    cv = cv_batches(tfx) * EPOCHS
    floats, n_split, split_floats = shard_floats(init_wts, model)
    width = read_wts(init_wts)[1]["w"].shape[1]
    rows = bunches * BUNCH // data
    cv_rows = sum(cv_windows(tfx)) * EPOCHS
    writer = k < model
    return {"colsum": bunches, "from_sums": bunches, "sgd": bunches,
            "calls": 2 * bunches if data > 1 else 0,
            "bytes": bunches * 4 * (257 + floats) if data > 1 else 0,
            "model_calls": 2 * bunches + cv,
            "model_bytes": 4 * width * (2 * rows + cv_rows),
            "model_gathers": bunches + cv + (n_split * EPOCHS if writer
                                             else 0),
            "model_gather_bytes": (4 * width // model * (rows + cv_rows)
                                   + (4 * split_floats * EPOCHS if writer
                                      else 0)),
            "data_gathers": 0, "replica_checks": EPOCHS,
            "ranks": data * model, "rank": k, "backend": backend}


def check_mesh_line(text: str, label: str, want: dict) -> dict:
    """A rank's closing ``data mesh:`` line against ``want`` -> its
    numbers."""
    got = mesh_summary(text, label)
    wrong = {key: (got[key], v) for key, v in want.items() if got[key] != v}
    if wrong:
        raise SystemExit(f"{label}: (got, wanted) {wrong}")
    return got


def rank0_files(out_dir: str, label: str) -> None:
    """Require that a mesh run left rank 0's files alone."""
    files = sorted(os.listdir(out_dir))
    if files != ["metrics.jsonl", "mlp.1.log", "mlp.1.wts", "mlp.2.log",
                 "mlp.2.wts"]:
        raise SystemExit(f"{label}: files on disk {files}: not rank 0's "
                         "alone")


def worst_change(init_wts: str, one_dir: str, got_dir: str) -> float:
    """Largest relative difference of the weight changes of ``got_dir``'s
    ``mlp.2.wts`` from ``one_dir``'s, over tensors."""
    return dp_epoch.worst_change(
        read_wts(init_wts), read_wts(os.path.join(one_dir, "mlp.2.wts")),
        read_wts(os.path.join(got_dir, "mlp.2.wts")))


def worst_cv(one_dir: str, got_dir: str) -> float:
    """Largest relative difference of the CV metrics in ``got_dir``'s
    ``metrics.jsonl`` from ``one_dir``'s, over epochs and metrics."""
    recs = []
    for d in (one_dir, got_dir):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            recs.append([json.loads(line) for line in f])
    return max(abs(g[k] - o[k]) / abs(o[k])
               for o, g in zip(*recs)
               for k in ("cv_squared_error", "cv_abs_error", "cv_ggd_loglik"))


def tp_train_runs(root: str, train: dict) -> dict:
    """``--mesh-data 1 --mesh-model 2`` and ``--mesh-data 2 --mesh-model 2``,
    ranks sharing the card over gloo at AGREE_LRATE, each twice, all as
    child processes started together.  -> the split kernels' launches."""
    tfx, init_wts = train["tfx"], train["init_wts"]
    bunches = ml_bunches(tfx) * EPOCHS
    cv = cv_batches(tfx) * EPOCHS
    runs = {}
    for data in TP_DATA:
        n = data * TP_MODEL
        for again in ("", "_again"):
            name = f"tp{data}x{TP_MODEL}{again}"
            port = free_port()
            runs[name] = (data, [start_rank(train_rank_argv(
                tfx, init_wts, os.path.join(root, name), "--lrate",
                AGREE_LRATE, "--mesh-model", str(TP_MODEL),
                *coordinator_flags(port, n, k, True)),
                os.path.join(root, f"{name}.{k}.log")) for k in range(n)])
    launches = {"colsum": 0, "from_sums": 0, "sgd": 0}
    for name, (data, ranks) in runs.items():
        outs = wait_ranks(ranks, name)
        for k, text in enumerate(outs):
            got = check_mesh_line(text, f"{name} rank {k}", tp_want(
                tfx, init_wts, data, TP_MODEL, k, "gloo"))
            mesh_replays(got, bunches, f"{name} rank {k}")
            for key in launches:
                launches[key] += got[key]
            if k == 0:
                print(f"tp      {name}: per bunch and rank, data axis "
                      f"{got['calls'] / bunches:.0f} all-reduces "
                      f"{got['bytes'] / bunches:.0f} bytes; model axis "
                      f"(training and {cv} CV batches) {got['model_calls']} "
                      f"all-reduces {got['model_bytes']} bytes, "
                      f"{got['model_gathers']} all-gathers "
                      f"{got['model_gather_bytes']} bytes in all; "
                      f"{got['colsum']} + {got['from_sums']} split GGD "
                      f"launches for {bunches} ML bunches")
        rank0_files(os.path.join(root, name), name)
        if name.endswith("_again"):
            first = name[:-len("_again")]
            again = same_bytes(os.path.join(root, first, "mlp.2.wts"),
                               os.path.join(root, name, "mlp.2.wts"))
            worst = worst_change(init_wts, os.path.join(root, "cuda_lr"),
                                 os.path.join(root, first))
            print(f"tp      {first}: replicas and shards equal at {EPOCHS} "
                  f"epoch ends on every rank, only rank 0's files, rerun "
                  f"byte-identical = {again}, weight changes within "
                  f"{worst:.3e} of the one-process card run at lrate "
                  f"{AGREE_LRATE}")
            if not (again and worst <= TRAIN_DW_RTOL):
                raise SystemExit(f"{first}: rerun identical {again}, weight "
                                 f"changes {worst:.3e} from one process")
    return launches


def tp_epoch_times(root: str, train: dict) -> None:
    """ms per bunch at 1 x 2 and 2 x 2 over gloo on the one card
    (``bench/dp_epoch.py --mesh-model 2``), one cluster at a time."""
    tfx, init_wts = train["tfx"], train["init_wts"]
    base = ["-m", "tpu_se_torch.bench.dp_epoch", "--fea-file", tfx["noisy"],
            "--targ-file", tfx["clean"], "--norm-file", tfx["norm"],
            "--init-wts", init_wts, "--train-sents", tfx["train_sents"],
            "--traincache", str(tfx["traincache"]), "--device", "cuda",
            "--mesh-model", str(TP_MODEL)]
    for data in TP_DATA:
        n = data * TP_MODEL
        port = free_port()
        ranks = [start_rank(base + coordinator_flags(port, n, k, True),
                            os.path.join(root, f"tp_epoch.{n}.{k}.log"))
                 for k in range(n)]
        for text in wait_ranks(ranks, f"dp_epoch {data}x{TP_MODEL}"):
            r = json.loads(text.strip().splitlines()[-1])
            b = r["bunches"]
            print(f"tp      {data}x{TP_MODEL} over gloo, rank {r['rank']}: "
                  f"{r['ms_per_bunch']:.3f} ms per bunch over {b} bunches "
                  f"of {r['rows_per_rank']} rows per rank; per bunch data "
                  f"axis {r['data_all_reduce_calls'] / b:.0f} all-reduces "
                  f"{r['data_all_reduce_bytes'] / b:.0f} bytes, model axis "
                  f"{r['model_all_reduce_calls'] / b:.0f} all-reduces "
                  f"{r['model_all_reduce_bytes'] / b:.0f} bytes and "
                  f"{r['model_all_gather_calls'] / b:.0f} all-gathers "
                  f"{r['model_all_gather_bytes'] / b:.0f} bytes; split "
                  f"launches {r['ggd_colsum_launches']} + "
                  f"{r['ggd_grad_from_sums_launches']}; gathered span equal "
                  f"= {r['span_equal']}")
            if not (r["span_equal"] and r["ggd_colsum_launches"] == b
                    and r["model_all_gather_calls"] == b):
                raise SystemExit(f"dp_epoch {data}x{TP_MODEL}: {r}")


def tp_phase(root: str, train: dict) -> dict:
    """-> the split kernels' launches on the tensor-parallel paths."""
    t0 = time.perf_counter()
    os.makedirs(root)
    os.symlink(os.path.join(os.path.dirname(root), "cuda_lr"),
               os.path.join(root, "cuda_lr"))
    launches = tp_train_runs(root, train)
    tp_epoch_times(root, train)
    print(f"tp      tensor-parallel phase wall time: "
          f"{time.perf_counter() - t0:.2f} s")
    return launches


def decoder_launches(outs: list, one_launches: int, label: str) -> int:
    """Each ``bench/mesh_decode`` rank's record: its LPS launches must be
    the one-process decode's and its graph replays ``MESH_HOPS``.  -> the
    ranks' LPS launches."""
    launches = 0
    for k, text in enumerate(outs):
        r = json.loads(text.strip().splitlines()[-1])
        if (r["lps_launches"], r["hops_replayed"]) != (one_launches,
                                                        MESH_HOPS):
            raise SystemExit(f"{label} {k}: {r}, wanted {one_launches} LPS "
                             f"launches (the one-process decode's) and "
                             f"{MESH_HOPS} replays")
        launches += r["lps_launches"]
    return launches


def hold_decode(got: list, one: dict, label: str
                ) -> tuple[float, float, dict]:
    """Every rank's ``decode_all`` arrays (``got``) against rank 0's
    (equal) and the one-process card decode's (``one``): waves within 1
    int16 LSB, enhanced LPS within rtol 1e-5, atol 1e-5, masks equal.  ->
    (worst LSB, worst LPS, whether each form's waves are bitwise)."""
    worst_lsb = worst_lps = 0.0
    bitwise = {}
    for key, want in one.items():
        if not all(np.array_equal(g[key], got[0][key]) for g in got[1:]):
            raise SystemExit(f"{label}: the ranks return different {key}")
        mine = got[0][key]
        form = key.rstrip("0123456789").replace("_wave", "").replace(
            "_lps", "")
        if mine.dtype == np.int16:
            lsb = wrapped_lsb(mine, want)
            worst_lsb = max(worst_lsb, lsb)
            bitwise[form] = bitwise.get(form, True) and np.array_equal(
                mine, want)
            if lsb > 1:
                raise SystemExit(f"{label} {key}: {lsb} LSB from the "
                                 "one-process card decode")
        elif mine.dtype == bool:
            if not np.array_equal(mine, want):
                raise SystemExit(f"{label} {key} differs")
        else:
            worst_lps = max(worst_lps, float(np.abs(mine - want).max()))
            if not np.allclose(mine, want, rtol=1e-5, atol=1e-5):
                raise SystemExit(f"{label} {key}: LPS "
                                 f"{np.abs(mine - want).max():.3e} from the "
                                 "one-process card decode")
    return worst_lsb, worst_lps, bitwise


def mesh_problem(root: str, fx: dict) -> tuple[dict, str]:
    """The decoder-mesh problem of the slice phase's waves and
    ``MESH_STREAMS`` x ``MESH_HOPS`` hops, written to ``root``."""
    problem = {"waves": np.concatenate(fx["waves"]),
               "lengths": np.array([len(w) for w in fx["waves"]]),
               "hops": stream_hops(fx["waves"], MESH_STREAMS, MESH_HOPS)}
    path = os.path.join(root, "problem.npz")
    np.savez(path, **problem)
    return problem, path


def mesh_decode_phase(root: str, fx: dict) -> tuple[int, dict]:
    """``Enhancer(mesh=)`` and ``StreamingEnhancer(mesh=)`` on two ranks
    sharing the card over gloo (``bench/mesh_decode.py``) against the
    card's one-process decode of the same waves and hops.  -> (LPS kernel
    launches on these paths, the one-process decode: its arrays ``one``
    and its LPS ``launches``)."""
    t0 = time.perf_counter()
    os.makedirs(root)
    problem, path = mesh_problem(root, fx)
    port = free_port()
    ranks = [start_rank(
        ["-m", "tpu_se_torch.bench.mesh_decode", "--wts", fx["wts"],
         "--norm", fx["norm"], "--problem", path, "--out", root,
         "--device", "cuda", *coordinator_flags(port, 2, k, True)],
        os.path.join(root, f"mesh_decode.{k}.log")) for k in (0, 1)]
    lps_kernel.launches = 0
    streaming.hops_replayed = 0
    one = decode_all(fx["wts"], fx["norm"], problem, None, "cuda")
    torch.cuda.synchronize()
    one_launches = lps_kernel.launches
    outs = wait_ranks(ranks, "2 decoder ranks over gloo")
    launches = one_launches + decoder_launches(outs, one_launches,
                                               "decoder rank")
    got = [dict(np.load(os.path.join(root, f"mesh_decode.{k}.npz")))
           for k in (0, 1)]
    worst_lsb, worst_lps, bitwise = hold_decode(got, one, "decoder mesh")
    # Where a form is not bitwise: one process given rank 0's rows of the
    # fast path's padded batch alone computes rank 0's bits, so the
    # difference is the row count of the products, not the mesh.
    batch, n_valid, _ = pad_batch(fx["waves"], "cuda")
    per = -(-len(fx["waves"]) // 2)
    enh = Enhancer(fx["wts"], fx["norm"], device="cuda")
    block = enh.decode_waves_tensor(batch[:per], n_valid[:per]).cpu().numpy()
    tail = enh.frame_length - enh.frame_shift
    same_block = all(np.array_equal(
        block[i, :int(n_valid[i]) * enh.frame_shift + tail],
        got[0][f"fast_wave{i}"]) for i in range(per))
    if not same_block:
        raise SystemExit("one process on rank 0's rows of the fast path's "
                         "batch does not compute rank 0's bits")
    print(f"mesh    one process given rank 0's {per} rows of the fast path's "
          f"batch alone: bitwise rank 0's waves = {same_block}")
    print(f"mesh    2 ranks over gloo on one card: Enhancer(mesh=) enhance "
          f"(plain, blend auto), enhance_batch, enhance_batch_waves of "
          f"{len(fx['waves'])} utterances, StreamingEnhancer(mesh=) of "
          f"{MESH_STREAMS} streams x {MESH_HOPS} hops (int16 wire); every "
          f"rank returns the same; against the one-process card decode: "
          f"waves within {worst_lsb:.0f} LSB (bitwise by form: {bitwise}), "
          f"enhanced LPS within {worst_lps:.3e}; LPS launches "
          f"{one_launches} per rank and in one process, {MESH_HOPS} replays "
          f"per rank; wall time {time.perf_counter() - t0:.2f} s")
    return launches, {"one": one, "launches": one_launches}


# The cross-card phase: NCCL, one rank per card.  Training meshes (data,
# model, products' dtype, runs) at AGREE_LRATE, held to the one-process
# card run; the meshes bench/dp_epoch times; the decoder meshes' data
# ranks; the timed enhance_batch_waves: passes, and the batch (the slice
# phase's utterances, repeated).
CARD_TRAIN = ((1, 2, "float32", 2), (1, 2, "bfloat16", 1),
              (2, 2, "float32", 2), (1, 4, "float32", 2))
CARD_EPOCH = ((2, 1), (1, 2), (1, 2, "bfloat16"), (4, 1), (2, 2), (1, 4))
CARD_DECODE = (2, 4)
# The overlapped step's data mesh across cards, replayed against eager.
CARD_OVERLAP = 4
RATE_PASSES = 20
RATE_REPEAT = 4
# The timed StreamingEnhancer(mesh=): channels, hops per push_many call,
# and timed windows of RATE_PASSES calls per variant.
RATE_STREAMS = 128
RATE_HOPS = 16
RATE_WINDOWS = 2
# A process running ``rate_child`` on the JSON object in its argument.
RATE_CHILD = "import sys, chip_smoke; chip_smoke.rate_child(sys.argv[1])"


def rate_child(arg: str) -> None:
    """One rank (or, with 0 ranks, one process) timing the decoders on the
    host clock, each window between a synchronise and a barrier at either
    end: ``enhance_batch_waves`` of the batch (two warm-up passes, then
    RATE_PASSES), then ``StreamingEnhancer.push_many(int16_wire=True)`` of
    the problem's ``RATE_STREAMS`` x ``RATE_HOPS`` hops (one call kept, one
    warm-up call, RATE_WINDOWS windows of RATE_PASSES calls, one call kept).
    Under a data mesh a second streamer has the row padding of
    ``_Step.rows`` taken out (its graphs captured again), and the windows
    of the two take turns: the padding's cost.  Writes the padded
    streamer's kept outputs to ``<out>.<rank>.npz``; its last line is
    "rate <json>"."""
    a = json.loads(arg)
    with np.load(a["problem"]) as z:
        waves = np.split(z["waves"], np.cumsum(z["lengths"])[:-1])
        hops = z["hops"]
    device, mesh = torch.device(a["device"]), None
    if a["ranks"]:
        info = initialize_distributed(a["coordinator"], a["ranks"],
                                      a["rank"], None, a["device"])
        device = info["device"]
        mesh = make_mesh(device=device)

    def window(fn, calls: int) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sync_processes("rate")
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sync_processes("rate")
        return time.perf_counter() - t

    try:
        enh = Enhancer(a["wts"], a["norm"], device=device, mesh=mesh)
        batch = waves * a["repeat"]
        for _ in range(2):
            out = enh.enhance_batch_waves(batch)
        seconds = window(lambda: enh.enhance_batch_waves(batch),
                         a["passes"])
        streamers = {"padded": StreamingEnhancer(
            a["wts"], a["norm"], n_streams=len(hops), device=device,
            mesh=mesh)}
        if mesh is not None and mesh.data > 1:
            plain = StreamingEnhancer(a["wts"], a["norm"],
                                      n_streams=len(hops), device=device,
                                      mesh=mesh)
            plain._step_args = plain._step_args._replace(rows=None)
            if plain._step_graph is not None:
                plain._step_graph = plain._capture(plain._step)
                plain._flush_graph = plain._capture(plain._flush)
                plain.reset()
            streamers["unpadded"] = plain
        kept = [streamers["padded"].push_many(hops, int16_wire=True)[0]]
        for s in streamers.values():
            s.push_many(hops, int16_wire=True)
        stream_s = {name: [] for name in streamers}
        for _ in range(a["windows"]):
            for name, s in streamers.items():
                stream_s[name].append(window(
                    lambda s=s: s.push_many(hops, int16_wire=True),
                    a["passes"]))
        kept.append(streamers["padded"].push_many(hops, int16_wire=True)[0])
    finally:
        shutdown_distributed()
    np.savez(f"{a['out']}.{a['rank']}.npz", first=kept[0], last=kept[1])
    print("rate " + json.dumps({
        "rank": a["rank"], "seconds": seconds, "utterances": len(out),
        "stream_seconds": stream_s, "lps_launches": lps_kernel.launches}))


def run_on_cards(clusters: list, root: str) -> dict:
    """Clusters of child ranks ``(name, n_ranks, argv(port, k))``, one rank
    per card, in order: as many started together as this process's cards
    hold without two sharing one, then each waited for (``wait_ranks``).
    Every rank of a cluster sees the cluster's cards and takes the k-th.
    -> name -> the ranks' outputs."""
    n_cards = torch.cuda.device_count()
    outs, todo = {}, list(clusters)
    while todo:
        started, used = [], 0
        while todo and used + todo[0][1] <= n_cards:
            name, n, argv = todo.pop(0)
            port = free_port()
            cards = tuple(range(used, used + n))
            started.append((name, [start_rank(
                argv(port, k), os.path.join(root, f"{name}.{k}.log"), cards)
                for k in range(n)]))
            used += n
        if not started:
            raise SystemExit(f"{todo[0][0]}: {todo[0][1]} ranks, "
                             f"{n_cards} cards")
        for name, ranks in started:
            outs[name] = wait_ranks(ranks, name)
    return outs


def card_train_runs(root: str, train: dict) -> dict:
    """``CARD_TRAIN``'s meshes that this machine's cards hold, through
    ``python -m tpu_se_torch train --mesh-model M`` over NCCL, one rank per
    card: each rank's closing line against the layout's collectives
    (``tp_want``), replicas equal at every epoch end, rank 0's files alone,
    weight changes and CV metrics against the one-process card run of the
    same products' dtype, and each float32 shape's rerun byte-identical.
    -> the split GGD and optimizer kernels' launches."""
    tfx, init_wts = train["tfx"], train["init_wts"]
    n_cards = torch.cuda.device_count()
    bunches = ml_bunches(tfx) * EPOCHS
    width = read_wts(init_wts)[1]["w"].shape[1]
    clusters, shapes = [], {}
    for data, model, dtype, times in CARD_TRAIN:
        n = data * model
        if n > n_cards:
            continue
        extra = ["--lrate", AGREE_LRATE, "--mesh-model", str(model)]
        if dtype != "float32":
            extra += ["--compute-dtype", dtype]
        for again in range(times):
            name = (f"nccl{data}x{model}_{dtype}"
                    + ("_again" if again else ""))
            shapes[name] = (data, model, dtype)
            clusters.append((
                name, n, lambda port, k, out=os.path.join(root, name), n=n,
                extra=extra: train_rank_argv(
                    tfx, init_wts, out, *extra,
                    *coordinator_flags(port, n, k, False))))
    outs = run_on_cards(clusters, root)
    launches = {"colsum": 0, "from_sums": 0, "sgd": 0}
    for name, texts in outs.items():
        data, model, dtype = shapes[name]
        replays = []
        for k, text in enumerate(texts):
            line = (f"data mesh: data={data}, model={model}, rank {k} on "
                    f"cuda:{k} (nccl)")
            if line not in text:
                raise SystemExit(f"{name} rank {k}: no '{line}' in\n{text}")
            got = check_mesh_line(text, f"{name} rank {k}", tp_want(
                tfx, init_wts, data, model, k, "nccl"))
            replays.append(mesh_replays(got, bunches, f"{name} rank {k}"))
            for key in launches:
                launches[key] += got[key]
            if k == 0:
                rank0 = got
        rank0_files(os.path.join(root, name), name)
        one = os.path.join(root, "cuda_lr" if dtype == "float32"
                           else "bf16_cuda_lr")
        dw = worst_change(init_wts, one, os.path.join(root, name))
        cv = worst_cv(one, os.path.join(root, name))
        bars = ((TRAIN_DW_RTOL, TRAIN_CV_RTOL) if dtype == "float32" else
                (BF16_TRAIN_DW_RTOL, BF16_TRAIN_CV_RTOL))
        again = ""
        if name.endswith("_again"):
            same = same_bytes(
                os.path.join(root, name[:-len("_again")], "mlp.2.wts"),
                os.path.join(root, name, "mlp.2.wts"))
            again = f"; mlp.2.wts byte-identical to the first run's = {same}"
            if not same:
                raise SystemExit(f"{name}: a rerun wrote other bytes")
        rows = BUNCH // data
        print(f"cards   {name} ({data}x{model} over NCCL, {dtype}, lrate "
              f"{AGREE_LRATE}): per bunch and rank, model axis 2 "
              f"all-reduces of {4 * width * rows} bytes and 1 all-gather "
              f"of {4 * width // model * rows} bytes, data axis "
              f"{rank0['calls'] / bunches:.0f} "
              f"all-reduces {rank0['bytes'] / bunches:.0f} bytes; in all "
              f"model axis {rank0['model_calls']} all-reduces "
              f"{rank0['model_bytes']} bytes, {rank0['model_gathers']} "
              f"all-gathers {rank0['model_gather_bytes']} bytes (rank 0, CV "
              f"and the writes included); {rank0['colsum']} + "
              f"{rank0['from_sums']} split GGD and {rank0['sgd']} optimizer "
              f"launches per rank for {bunches} ML bunches (per rank: "
              f"{'; '.join(replays)}); replicas equal "
              f"at {rank0['replica_checks']} epoch ends on every rank; weight "
              f"changes within {dw:.3e} and CV metrics within {cv:.3e} of "
              f"the one-process {dtype} card run (bars {bars[0]}, "
              f"{bars[1]}){again}")
        if not (dw <= bars[0] and cv <= bars[1]):
            raise SystemExit(f"{name}: weight changes {dw:.3e}, CV "
                             f"{cv:.3e} from one process")
    return launches


def card_epoch_times(root: str, train: dict,
                     shapes: tuple = (None,) + CARD_EPOCH,
                     profile: tuple = ()) -> dict:
    """ms per global bunch of ``shapes`` ((data, model[, products' dtype])
    meshes over NCCL, or None: one process, the one-device step) that the
    cards hold, one cluster at a time, through ``python -m
    tpu_se_torch.bench.dp_epoch``; each reading is one run's timed epoch.
    A mesh replays its bunches and is held to its eager loop in the same
    ranks (``--against-eager``: bitwise, launches and collectives equal,
    epochs in turns).  The shapes in ``profile`` also trace a window of
    replayed bunches on every rank (``--profile``): NCCL and compute
    kernels, busy time and idle share.  -> the GGD kernels' launches
    (fused, split) in these runs."""
    tfx, init_wts = train["tfx"], train["init_wts"]
    n_cards = torch.cuda.device_count()
    base = ["-m", "tpu_se_torch.bench.dp_epoch", "--fea-file", tfx["noisy"],
            "--targ-file", tfx["clean"], "--norm-file", tfx["norm"],
            "--init-wts", init_wts, "--train-sents", tfx["train_sents"],
            "--traincache", str(tfx["traincache"]), "--device", "cuda"]
    launches = {"fused": 0, "colsum": 0, "from_sums": 0}
    for shape in shapes:
        data, model, dtype = (*shape, "float32")[:3] if shape else (1, 1, "")
        n = data * model
        if n > n_cards:
            continue
        name = (f"epoch{data}x{model}{'_' + dtype if dtype else ''}"
                if shape else "epoch_one")
        extra = ((["--profile"] if shape in profile else [])
                 + ([] if dtype in ("", "float32") else
                    ["--compute-dtype", dtype]))
        flags = (lambda port, k, n=n, model=model: coordinator_flags(
            port, n, k, False) + ["--mesh-model", str(model),
                                  "--against-eager"]) if shape \
            else (lambda port, k: [])
        texts = run_on_cards([(name, n, lambda port, k, flags=flags:
                               base + flags(port, k) + extra)],
                             root)[name]
        recs = [json.loads(text.strip().splitlines()[-1]) for text in texts]
        r, b = recs[0], recs[0]["bunches"]
        per = {key: r[key] / b for key in r
               if key.startswith(("data_", "model_"))}
        label = ("one process, one-device step" if not shape else
                 f"{data}x{model} over NCCL, {dtype}")
        held = [against_eager(x, f"dp_epoch {label} rank {x['rank']}")
                for x in recs] if shape else [
                    f"{r['bunches_replayed']} bunches replayed"]
        print(f"cards   dp_epoch {label}: "
              f"{', '.join(f'{x['ms_per_bunch']:.4f}' for x in recs)} ms "
              f"per global bunch (rank 0 first) over {b} bunches of "
              f"{r['rows_per_rank']} rows per rank; rank 0 {held[0]}; per "
              f"bunch and rank {json.dumps(per)}; GGD launches (fused, "
              f"colsum, from_sums) {r['ggd_launches_both_epochs']} over both "
              f"epochs; gathered span equal = {r['span_equal']}")
        for x in recs if "--profile" in extra else ():
            prof = x["profile"]
            print(f"cards   dp_epoch {label} rank {x['rank']}, "
                  f"{prof['bunches']} bunches traced (replayed = "
                  f"{prof['replayed']}): wall {prof['wall_ms']:.4f} ms, "
                  f"device busy {prof['busy_us']:.1f} us (compute "
                  f"{prof['compute_busy_us']:.1f} us, {prof['gemm_kernels']} "
                  f"GEMM kernels; NCCL kernels {prof['nccl_kernels']}, "
                  f"{prof['nccl_us']:.1f} us in all) per bunch, idle share "
                  f"{prof['idle_share']:.4f}; collectives per bunch "
                  f"{json.dumps(prof['collectives_per_bunch'])}; host ops by "
                  f"self time, us per bunch: "
                  + ", ".join(f"{op} {us:.1f}" for op, us
                              in prof["host_self_us"].items()))
            check_replayed_profile(f"dp_epoch {label} rank {x['rank']}",
                                   prof, len(read_wts(init_wts)), n)
        split = b if shape else 0
        for x in recs:
            if not (x["span_equal"]
                    and (x["ggd_colsum_launches"],
                         x["ggd_grad_from_sums_launches"],
                         x["ggd_output_grad_launches"])
                    == (split, split, b - split)
                    and x.get("model_all_gather_calls", 0) == (
                        b if model > 1 else 0)):
                raise SystemExit(f"dp_epoch {label}: {x}")
            for key, got in zip(launches, x["ggd_launches_both_epochs"]):
                launches[key] += got
    return launches


def card_decode_runs(root: str, fx: dict, one: dict,
                     one_launches: int) -> int:
    """``bench/mesh_decode`` over NCCL at ``CARD_DECODE``'s data ranks that
    the cards hold, one rank per card, against the one-process card decode
    (``one``, with ``one_launches`` LPS launches): the bars of
    ``mesh_decode_phase`` (``hold_decode``), the int16 streams bitwise,
    each rank's LPS launches the one process's.  Then the decoders timed by
    ``rate_child`` in one process and at each of those rank counts, the
    ``RATE_STREAMS`` streams of every rank bitwise one process's.  -> the
    LPS kernel's launches."""
    n_cards = torch.cuda.device_count()
    _, path = mesh_problem(root, fx)
    launches = 0
    sizes = [n for n in CARD_DECODE if n <= n_cards]
    for n in sizes:
        name = f"decode{n}"
        out = os.path.join(root, name)
        os.makedirs(out)
        texts = run_on_cards([(name, n, lambda port, k, n=n, out=out: [
            "-m", "tpu_se_torch.bench.mesh_decode", "--wts", fx["wts"],
            "--norm", fx["norm"], "--problem", path, "--out", out,
            "--device", "cuda", *coordinator_flags(port, n, k, False)])],
            root)[name]
        launches += decoder_launches(texts, one_launches, f"{name} rank")
        got = [dict(np.load(os.path.join(out, f"mesh_decode.{k}.npz")))
               for k in range(n)]
        lsb, lps, bitwise = hold_decode(got, one, f"{name} over NCCL")
        print(f"cards   {n} decoder ranks over NCCL: Enhancer(mesh=) "
              f"enhance (plain, blend auto), enhance_batch, "
              f"enhance_batch_waves of {len(fx['waves'])} utterances, "
              f"StreamingEnhancer(mesh=) of {MESH_STREAMS} streams x "
              f"{MESH_HOPS} hops (int16 wire, {MESH_STREAMS // n} channels "
              f"per rank); every rank returns the same; against the "
              f"one-process card decode: waves within {lsb:.0f} LSB "
              f"(bitwise by form: {bitwise}), enhanced LPS within "
              f"{lps:.3e}; LPS launches {one_launches} per rank and in one "
              f"process, {MESH_HOPS} replays per rank")
        if not bitwise["stream"]:
            raise SystemExit(f"{name}: the int16 streams are not one "
                             "process's bits")
    rate_path = os.path.join(root, "rate.npz")
    np.savez(rate_path, waves=np.concatenate(fx["waves"]),
             lengths=np.array([len(w) for w in fx["waves"]]),
             hops=stream_hops(fx["waves"], RATE_STREAMS, RATE_HOPS))
    ts = [len(w) // SHIFT - 1 for w in fx["waves"]]
    frames = RATE_REPEAT * sum(ts) * RATE_PASSES
    hops = RATE_HOPS * RATE_PASSES
    rates, streams, reference = {}, {}, None
    for n in [0] + sizes:
        name = f"rate{n}"
        texts = run_on_cards([(name, max(n, 1), lambda port, k, n=n: [
            "-u", "-c", RATE_CHILD, json.dumps({
                "problem": rate_path, "wts": fx["wts"], "norm": fx["norm"],
                "ranks": n, "rank": k, "coordinator": f"127.0.0.1:{port}",
                "device": "cuda", "repeat": RATE_REPEAT,
                "passes": RATE_PASSES, "windows": RATE_WINDOWS,
                "out": os.path.join(root, name)})])],
            root)[name]
        recs = [json.loads(line[len("rate "):]) for text in texts
                for line in text.splitlines() if line.startswith("rate ")]
        if len(recs) != max(n, 1) or any(
                r["utterances"] != RATE_REPEAT * len(fx["waves"])
                for r in recs):
            raise SystemExit(f"{name}: {texts}")
        launches += sum(r["lps_launches"] for r in recs)
        rates[n] = frames / recs[0]["seconds"]
        streams[n] = {variant: [s / hops * 1e3 for s in seconds]
                      for variant, seconds in recs[0]["stream_seconds"].items()}
        kept = [dict(np.load(os.path.join(root, f"{name}.{k}.npz")))
                for k in range(max(n, 1))]
        reference = reference or kept[0]
        if not all(np.array_equal(got[key], want) for got in kept
                   for key, want in reference.items()):
            raise SystemExit(f"{name}: the {RATE_STREAMS} int16 streams are "
                             "not one process's bits on every rank")
    print(f"cards   enhance_batch_waves of a batch of "
          f"{RATE_REPEAT * len(fx['waves'])} utterances "
          f"({frames // RATE_PASSES} frames), {RATE_PASSES} passes, host "
          f"clock: "
          + "; ".join(f"{'one card' if n == 0 else f'{n} data ranks'} "
                      f"{fps:.0f} frames/s ({fps / rates[0]:.3f} of one "
                      f"card)" for n, fps in rates.items()))
    print(f"cards   StreamingEnhancer push_many of {RATE_STREAMS} streams "
          f"(int16 wire) in {RATE_HOPS}-hop calls, {RATE_WINDOWS} windows "
          f"of {hops} hops in turns, host clock, ms per hop of all streams: "
          + "; ".join(
              f"{'one card' if n == 0 else f'{n} data ranks'} "
              + ", ".join((f"{variant} " if n else "")
                          + " / ".join(f"{ms:.4f}" for ms in per)
                          for variant, per in by.items())
              for n, by in streams.items())
          + "; every rank's streams bitwise one process's (the padded "
          "ones)")
    return launches


def cards_phase(root: str, fx: dict, train: dict, decoded: dict) -> dict:
    """The mesh paths over NCCL, one rank per card, as far as this
    machine's cards go, the decoders held to the one-process card decode
    of ``mesh_decode_phase`` (``decoded``); one line names what needs more
    cards than there are.  -> the kernels' launches on these paths."""
    t0 = time.perf_counter()
    os.makedirs(root)
    for name in ("cuda_lr", os.path.join("bf16", "cuda_lr")):
        os.symlink(os.path.join(os.path.dirname(root), name),
                   os.path.join(root, name.replace(os.sep, "_")))
    n_cards = torch.cuda.device_count()
    for line in subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines():
        print(f"cards   {line}")
    needs = {}
    for data, model, dtype, times in CARD_TRAIN:
        needs.setdefault(data * model, []).append(
            f"train {data}x{model} {dtype} x{times}")
    for data, model, *dtype in CARD_EPOCH:
        needs.setdefault(data * model, []).append(
            f"dp_epoch {data}x{model}{' ' + dtype[0] if dtype else ''}")
    for n in CARD_DECODE:
        needs.setdefault(n, []).append(
            f"mesh_decode and the decoders' rates at {n} ranks")
    needs.setdefault(CARD_OVERLAP, []).append(
        f"the overlapped step {CARD_OVERLAP}x1 replayed against eager")
    left = [f"{', '.join(runs)} (each needs {n} cards)"
            for n, runs in sorted(needs.items()) if n > n_cards]
    print(f"cards   left out on {n_cards} card{'s' * (n_cards > 1)}: "
          f"{'; '.join(left) if left else 'none'}")
    launches = {"colsum": 0, "from_sums": 0, "sgd": 0, "fused": 0, "lps": 0}
    if n_cards >= min(needs):
        for key, n in card_train_runs(root, train).items():
            launches[key] += n
        for key, n in card_epoch_times(root, train).items():
            launches[key] += n
        launches["lps"] = card_decode_runs(root, fx, decoded["one"],
                                           decoded["launches"])
    if n_cards >= CARD_OVERLAP:
        for key, n in overlap_mesh_runs(root, train, CARD_OVERLAP,
                                        ("float32",), True, "cards").items():
            launches[key] += n
    print(f"cards   cross-card phase wall time: "
          f"{time.perf_counter() - t0:.2f} s; launches {launches}")
    return launches


@contextlib.contextmanager
def numpy_reads():
    """Within the block, the training loop's datasets read with numpy
    (``use_native=False``), the route the host chunk loader is held to."""
    saved = loop_mod.PfilePairDataset
    loop_mod.PfilePairDataset = functools.partial(saved, use_native=False)
    try:
        yield
    finally:
        loop_mod.PfilePairDataset = saved


def native_phase(dev, root: str, train: dict) -> None:
    """The host chunk loader on the card's host: its build, its rows
    against numpy's (bitwise), their MB/s, 2 per-chunk epochs through
    either route (byte-identical ``.wts``), and epoch samples/s."""
    t0 = time.perf_counter()
    os.makedirs(root)
    tfx, init_wts = train["tfx"], train["init_wts"]
    cxx = _build.host_compiler()
    t = time.perf_counter()
    subprocess.run(_build.host_command(cxx, [_build.HOST_SOURCE],
                                       os.path.join(root, "host.so")),
                   check=True, capture_output=True, text=True)
    compile_s = time.perf_counter() - t
    t = time.perf_counter()
    lib_path, _ = _build.build_host_library()
    native._load()
    print(f"native  host library: {cxx} {' '.join(_build.HOST_FLAGS)} "
          f"compiles csrc/chunk_loader.cc in {compile_s:.2f} s; "
          f"build_host_library + load {time.perf_counter() - t:.2f} s "
          f"({os.path.basename(lib_path)})")

    lo, hi = (int(x) for x in tfx["train_sents"].split("-"))
    args = (tfx["noisy"], tfx["clean"], tfx["norm"], (lo, hi),
            tfx["traincache"])
    routes = {"host chunk loader": PfilePairDataset(*args),
              "numpy": PfilePairDataset(*args, use_native=False)}
    spans, rates = {}, {}
    for name, ds in routes.items():
        runs = []
        for _ in range(NATIVE_READS):
            t = time.perf_counter()
            spans[name] = ds.load_span_normalized()
            runs.append(time.perf_counter() - t)
        rates[name] = ds.span_bytes() / 1e6 / sorted(runs)[len(runs) // 2]
    same = all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
               for a, b in zip(*spans.values()))
    mb = routes["numpy"].span_bytes() / 1e6
    print(f"native  read + swap + normalise of the training span (noisy + "
          f"clean, {mb:.2f} MB of float32 rows, page cache warm), median of "
          f"{NATIVE_READS}: host chunk loader "
          f"{rates['host chunk loader']:.1f} MB/s, numpy "
          f"{rates['numpy']:.1f} MB/s ({rates['host chunk loader'] / rates['numpy']:.2f}x); "
          f"rows bitwise equal = {same}")
    if not same:
        raise SystemExit("the host chunk loader's rows differ from numpy's")

    wts = {}
    for name, reads in (("native", contextlib.nullcontext()),
                        ("numpy", numpy_reads())):
        out = os.path.join(root, f"per_chunk_{name}")
        t = time.perf_counter()
        with reads:
            wts[name] = run_training(TrainConfig(
                fea_file=tfx["noisy"], targ_file=tfx["clean"],
                norm_file=tfx["norm"], init_wts_file=init_wts, out_dir=out,
                train_sent_range=(lo, hi), cv_sent_range=tuple(
                    int(x) for x in tfx["cv_sents"].split("-")),
                traincache=tfx["traincache"], epochs=EPOCHS,
                device_resident="never"), dev, log=lambda s: None)
        print(f"native  train --epochs {EPOCHS} per chunk "
              f"(device_resident='never'), rows by {name}: "
              f"{time.perf_counter() - t:.2f} s")
    identical = same_bytes(*wts.values())
    resident = same_bytes(wts["native"],
                          os.path.join(os.path.dirname(root), "cuda",
                                       "mlp.2.wts"))
    print(f"native  per-chunk mlp.2.wts by the host chunk loader and by "
          f"numpy byte-identical = {identical}; equal to the resident "
          f"training phase's = {resident}")
    if not identical:
        raise SystemExit("per-chunk training differs between the host "
                         "chunk loader and numpy")
    for use_native in (None, False):
        train_rate(dev, tfx, init_wts, resident=False, use_native=use_native)
    train_rate(dev, tfx, init_wts)
    print(f"native  host chunk loader phase wall time: "
          f"{time.perf_counter() - t0:.2f} s")


def overlap_epoch_argv(tfx: dict, init_wts: str, out: str, *extra) -> list:
    return ["-m", "tpu_se_torch.bench.dp_epoch", "--fea-file", tfx["noisy"],
            "--targ-file", tfx["clean"], "--norm-file", tfx["norm"],
            "--init-wts", init_wts, "--train-sents", tfx["train_sents"],
            "--traincache", str(tfx["traincache"]), "--device", "cuda",
            "--lrate", AGREE_LRATE, "--out", out, *extra]


# The overlapped step against its eager loop and the flat step: the order
# of the timed epochs (2 then 3) of the three states, in turns.
OVERLAP_TURNS = ("overlap", "flat", "eager", "eager", "flat", "overlap")
# A process running ``overlap_child`` on the JSON object in its argument.
OVERLAP_CHILD = "import sys, chip_smoke; chip_smoke.overlap_child(sys.argv[1])"


def overlap_epochs(dev, tfx: dict, init_wts: str, dtype: str = "float32",
                   mesh=None) -> dict:
    """Three states from the same weights over the training fixtures'
    resident span, at lrate ``AGREE_LRATE``: ``train_chunk_overlap``
    replayed ("overlap"), the same step eager ("eager", ``graph=False``)
    and ``train_chunk`` replayed ("flat"); a warm-up epoch each (a capture
    each replayed state), then epochs 2 and 3 in ``OVERLAP_TURNS``, each
    between a synchronise and a barrier (host clock).  -> the states, ms
    per bunch of each, each state's first timed epoch's counts
    (``read_counts``, then bunches replayed and graphs captured), the
    bunches of an epoch, and the dataset, frames and hyper-parameters."""
    lo, hi = (int(x) for x in tfx["train_sents"].split("-"))
    cfg = TrainConfig(train_sent_range=(lo, hi), traincache=tfx["traincache"],
                      lrate=float(AGREE_LRATE), compute_dtype=dtype)
    ds = PfilePairDataset(tfx["noisy"], tfx["clean"], tfx["norm"],
                          cfg.train_sent_range, cfg.traincache)
    frames = load_device_frames(ds, dev, mesh)
    hyper = cfg.hyper()
    steps = {"overlap": train_chunk_overlap,
             "eager": functools.partial(train_chunk_overlap, graph=False),
             "flat": train_chunk}
    states = {name: load_checkpoint(init_wts, dev, mesh=mesh)
              for name in steps}
    traffic = None if mesh is None else mesh.traffic

    def counts() -> list:
        return [*step_mod.read_counts(traffic), step_mod.bunches_replayed,
                step_mod.graphs_captured]

    def epoch(name: str, number: int) -> tuple[float, list]:
        before = counts()
        torch.cuda.synchronize(dev)
        sync_processes("overlap")
        t = time.perf_counter()
        train_one_epoch(states[name], ds, hyper, cfg.lr_for_epoch(number),
                        np.random.default_rng(cfg.seed_for_epoch(number)),
                        dev, device_frames=frames, log=lambda s: None,
                        mesh=mesh, step=steps[name])
        torch.cuda.synchronize(dev)
        sync_processes("overlap")
        return (time.perf_counter() - t, [b - a for a, b in
                                          zip(before, counts())])

    for name in steps:
        epoch(name, 1)
    bunches = ml_bunches(tfx)
    ms, moved = {name: [] for name in steps}, {}
    for i, name in enumerate(OVERLAP_TURNS):
        seconds, got = epoch(name, 2 if i < len(steps) else 3)
        ms[name].append(seconds / bunches * 1e3)
        moved.setdefault(name, got)
    return {"states": states, "ms": ms, "moved": moved, "bunches": bunches,
            "ds": ds, "frames": frames, "hyper": hyper}


def overlap_unsharded(dev, tfx: dict, init_wts: str) -> int:
    """``overlap_epochs`` at ``mesh=None`` on the card: the replayed
    overlapped state bit for bit its eager loop's and the replayed flat
    step's (in float32 at ``mesh=None`` every operation is one autograd
    runs), one capture per replayed state, one fused GGD launch per
    bunch; ms per bunch of the three in turns.  -> fused GGD launches."""
    t0 = time.perf_counter()
    zero_train_counts()
    run = overlap_epochs(dev, tfx, init_wts)
    states, bunches = run["states"], run["bunches"]
    launches = ggd_kernel.launches
    eager, worst = same_state(states["overlap"], states["eager"])
    flat, worst_flat = same_state(states["overlap"], states["flat"])
    replays = replay_check("mesh=None replayed", 2 * 3 * bunches)
    ms = {k: ", ".join(f"{t:.4f}" for t in v) for k, v in run["ms"].items()}
    print(f"overlap mesh=None on the card, 3 epochs each at lrate "
          f"{AGREE_LRATE} from the same weights: train_chunk_overlap "
          f"replayed against its eager loop bitwise = {eager} (largest "
          f"difference {worst:.3e}), against train_chunk replayed bitwise "
          f"= {flat} ({worst_flat:.3e}); {replays}; fused GGD launches "
          f"{launches} for 3 x 3 x {bunches} ML bunches; ms per bunch "
          f"(epochs 2 and 3 in turns) overlapped replayed {ms['overlap']}, "
          f"flat replayed {ms['flat']}, overlapped eager {ms['eager']}; "
          f"{time.perf_counter() - t0:.2f} s; {card_line()}")
    if not (eager and flat):
        raise SystemExit(f"mesh=None: the replayed train_chunk_overlap "
                         f"differs from its eager loop ({worst:.3e}) or "
                         f"from train_chunk ({worst_flat:.3e})")
    if launches != 9 * bunches or step_mod.graphs_captured != 2:
        raise SystemExit(f"mesh=None: {launches} fused GGD launches for "
                         f"9 x {bunches} bunches, "
                         f"{step_mod.graphs_captured} captures")
    return launches


def overlap_child(arg: str) -> None:
    """One NCCL rank of a ``ranks`` x 1 data mesh (one card a rank):
    ``overlap_epochs`` for each of ``dtypes``, then, with ``profile``, a
    traced window of replayed bunches of the overlapped and of the flat
    state (``bench/dp_epoch.profile_bunches``).  Prints "overlap-child
    <json>": per dtype whether the replayed overlapped state is its eager
    loop's bit for bit (and the flat step's), the first timed epochs'
    counts of each state, ms per global bunch, and the traces; then the
    split GGD and optimizer kernels' launches of the process."""
    a = json.loads(arg)
    info = initialize_distributed(a["coordinator"], a["ranks"], a["rank"],
                                  None, "cuda")
    out = {"rank": a["rank"], "ranks": a["ranks"], "runs": {}}
    try:
        dev = info["device"]
        mesh = make_mesh(None, 1, dev)
        for dtype in a["dtypes"]:
            run = overlap_epochs(dev, a["tfx"], a["init_wts"], dtype, mesh)
            states = run["states"]
            got = {"bunches": run["bunches"], "ms": run["ms"],
                   "moved": run["moved"]}
            got["bitwise"], got["max_abs_diff"] = same_state(
                states["overlap"], states["eager"])
            got["flat_bitwise"], _ = same_state(states["overlap"],
                                                states["flat"])
            if a["profile"]:
                got["profile"] = {name: dp_epoch.profile_bunches(
                    states[name], run["ds"], run["frames"], run["hyper"],
                    step, mesh, dp_epoch.PROFILE_BUNCHES, dev)
                    for name, step in (("overlap", train_chunk_overlap),
                                       ("flat", train_chunk))}
            out["runs"][dtype] = got
    finally:
        shutdown_distributed()
    out["launches"] = {"colsum": ggd_kernel.colsum_launches,
                       "from_sums": ggd_kernel.grad_from_sums_launches,
                       "sgd": sgd_kernel.launches}
    print("overlap-child " + json.dumps(out))


def overlap_mesh_runs(root: str, train: dict, ranks: int, dtypes: tuple,
                      profile: bool, tag: str) -> dict:
    """``overlap_child`` on ``ranks`` NCCL ranks, one card each: on every
    rank and for each dtype the replayed overlapped step bit for bit its
    eager loop, the first timed epochs' launches and ``Mesh.traffic`` of
    the two equal to the byte (the column sums and one all-reduce per
    layer, two in bfloat16, per bunch), every bunch of the replayed one a
    replay and none of the eager one's; ms per global bunch of the three
    states in turns; with ``profile`` every rank's replayed window of the
    overlapped and the flat step (``check_replayed_profile``) and the µs
    its NCCL kernels ran beside GEMM kernels.  -> the split GGD and
    optimizer kernels' launches."""
    t0 = time.perf_counter()
    tfx, init_wts = train["tfx"], train["init_wts"]
    n_layers = len(read_wts(init_wts))
    name = f"overlap{ranks}x1"
    texts = run_on_cards([(name, ranks, lambda port, k: [
        "-u", "-c", OVERLAP_CHILD, json.dumps({
            "tfx": tfx, "init_wts": init_wts, "ranks": ranks, "rank": k,
            "coordinator": f"127.0.0.1:{port}", "dtypes": list(dtypes),
            "profile": profile})])], root)[name]
    recs = [json.loads(line[len("overlap-child "):]) for text in texts
            for line in text.splitlines()
            if line.startswith("overlap-child ")]
    if len(recs) != ranks:
        raise SystemExit(f"{tag}: {texts}")
    launches = {"colsum": 0, "from_sums": 0, "sgd": 0}
    for r in recs:
        for key in launches:
            launches[key] += r["launches"][key]
        for dtype, got in r["runs"].items():
            label = f"{tag} {ranks}x1 {dtype} rank {r['rank']}"
            b = got["bunches"]
            over, eager = got["moved"]["overlap"], got["moved"]["eager"]
            per_layer = 1 if dtype == "float32" else 2
            if not (got["bitwise"] and over[:-2] == eager[:-2]
                    and over[-2:] == [b, 0] and eager[-2:] == [0, 0]
                    and over[:4] == [0, b, b, b]
                    and over[4] == b * (1 + per_layer * n_layers)):
                raise SystemExit(f"{label}: the replayed overlapped step "
                                 f"against its eager loop (largest "
                                 f"difference {got['max_abs_diff']:.3e}): "
                                 f"{got}")
            ms = {k: " / ".join(f"{t:.4f}" for t in v)
                  for k, v in got["ms"].items()}
            print(f"overlap {label}: replayed bitwise its eager loop, "
                  f"launches and collectives equal ({over[4] // b} "
                  f"all-reduces, {over[5] // b} bytes per bunch), {b} of "
                  f"{b} bunches replayed; bitwise the flat step = "
                  f"{got['flat_bitwise']}; ms per global bunch (epochs 2 "
                  f"and 3 in turns) overlapped replayed {ms['overlap']}, "
                  f"flat replayed {ms['flat']}, overlapped eager "
                  f"{ms['eager']}")
            for step, prof in got.get("profile", {}).items():
                check_replayed_profile(f"{label} {step}", prof, n_layers,
                                       ranks)
                print(f"overlap {label} {step}, {prof['bunches']} replayed "
                      f"bunches traced: NCCL kernels {prof['nccl_kernels']} "
                      f"({prof['nccl_us']:.1f} us), GEMM kernels "
                      f"{prof['gemm_kernels']}, overlapping for "
                      f"{prof['nccl_gemm_overlap_us']:.1f} us; per bunch "
                      f"wall {prof['wall_ms']:.4f} ms, busy "
                      f"{prof['busy_us']:.1f} us (compute "
                      f"{prof['compute_busy_us']:.1f}), idle share "
                      f"{prof['idle_share']:.4f}")
    print(f"overlap {tag} {ranks}x1: {time.perf_counter() - t0:.2f} s with "
          f"the ranks' start; {card_line()}")
    return launches


def check_replayed_profile(label: str, prof: dict, n_layers: int,
                           ranks: int) -> None:
    """A trace of replayed flat bunches (``bench/dp_epoch.py --profile``)
    must show every traced bunch replayed, at least a bunch's products
    (3 x layers - 1) as GEMM kernels per bunch, and NCCL kernels where more
    than one rank sums (one NCCL rank launches none for an in-place
    sum)."""
    gemms = prof["bunches"] * (3 * n_layers - 1)
    if not (prof["replayed"] and prof["gemm_kernels"] >= gemms
            and (ranks == 1 or prof["nccl_kernels"] > 0)):
        raise SystemExit(f"{label}: a replayed window with "
                         f"{prof['gemm_kernels']} GEMM kernels (wanted at "
                         f"least {gemms}) and {prof['nccl_kernels']} NCCL "
                         f"kernels over {ranks} ranks: {prof}")


def show_profile(name: str, prof: dict, n_layers: int, step: str,
                 ranks: int) -> None:
    """Print (and check) ``bench/dp_epoch.py --profile``'s trace.  Eager
    bunches (gloo): the backward products issued while a bunch's gradient
    all-reduces were in flight (the overlapped step issues two per hidden
    layer behind its first ring, the flat step none).  Replayed bunches
    (either step over NCCL): the trace holds the bunch's GEMM kernels and,
    over more than one rank, NCCL kernels (``check_replayed_profile``).
    Both: the device time NCCL kernels share with GEMM kernels, and the
    host ops of most self time per bunch."""
    if prof["replayed"]:
        issued = (f"replayed bunches, collectives per bunch (Mesh.traffic) "
                  f"{json.dumps(prof['collectives_per_bunch'])}")
    else:
        issued = (f"host op {prof['all_reduce_op']!r} x "
                  f"{prof['all_reduces']}; backward products issued after "
                  f"a bunch's first gradient all-reduce: "
                  f"{sorted(set(prof['products_in_flight']))}")
    print(f"overlap {name} under torch.profiler, {prof['bunches']} bunches: "
          f"{issued}; device: "
          f"{prof['nccl_kernels']} NCCL kernels ({prof['nccl_us']:.1f} us), "
          f"{prof['gemm_kernels']} GEMM kernels, overlapping for "
          f"{prof['nccl_gemm_overlap_us']:.1f} us")
    ops = ", ".join(f"{k} {v:.1f}" for k, v in prof["host_self_us"].items())
    print(f"overlap {name} per bunch under torch.profiler: wall "
          f"{prof['wall_ms']:.3f} ms, device kernels {prof['kernel_us']:.1f}"
          f" us, busy {prof['busy_us']:.1f} us, idle share "
          f"{prof['idle_share']:.4f}; host self us: {ops}")
    if prof["replayed"]:
        check_replayed_profile(f"overlap {name}", prof, n_layers, ranks)
        return
    want = 2 * (n_layers - 1) if step == "overlap" else 0
    if set(prof["products_in_flight"]) != {want}:
        raise SystemExit(f"overlap {name}: {prof['products_in_flight']} "
                         f"backward products behind the first gradient "
                         f"all-reduce, wanted {want} per bunch")


def overlap_runs(root: str, train: dict) -> dict:
    """One NCCL rank and two gloo ranks sharing the card, each step, one
    cluster at a time (timed), then each overlapped form again (together)
    and the bfloat16 ring at one NCCL rank; held to one process.  -> the
    split GGD launches of these runs."""
    tfx, init_wts = train["tfx"], train["init_wts"]
    bunches = ml_bunches(tfx)
    n_layers = len(read_wts(init_wts))
    launches = {"colsum": 0, "from_sums": 0, "fused": 0}
    one = {}
    for dtype in ("float32", "bfloat16"):
        one[dtype] = os.path.join(root, f"one_{dtype}.wts")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            dp_epoch.main(overlap_epoch_argv(tfx, init_wts, one[dtype])[2:]
                          + ["--compute-dtype", dtype])
        r = json.loads(text.getvalue().strip().splitlines()[-1])
        launches["fused"] += r["ggd_launches_both_epochs"][0]
        print(f"overlap one process, flat step, {dtype}, lrate "
              f"{AGREE_LRATE}: {r['ms_per_bunch']:.3f} ms per bunch, "
              f"{r['ggd_launches_both_epochs'][0]} fused GGD launches")

    def cluster(name, n_ranks, gloo, *extra):
        port = free_port()
        return [start_rank(overlap_epoch_argv(
            tfx, init_wts, os.path.join(root, f"{name}.wts"), *extra,
            *coordinator_flags(port, n_ranks, k, gloo)),
            os.path.join(root, f"{name}.{k}.log")) for k in range(n_ranks)]

    def finish(name, ranks, dtype="float32"):
        results = [json.loads(text.strip().splitlines()[-1])
                   for text in wait_ranks(ranks, f"overlap {name}")]
        per_layer = 2 if dtype == "bfloat16" else 1
        for r in results:
            both = r["ggd_launches_both_epochs"]
            calls = r["all_reduce_calls"]
            want = bunches * (per_layer * n_layers + 1
                              if r["step"] == "overlap" else 2)
            replays = bunches if r["backend"] == "nccl" else 0
            if not (r["span_equal"] and both == [0, 2 * bunches,
                                                 2 * bunches]
                    and calls == want
                    and r["bunches_replayed"] == replays):
                raise SystemExit(f"overlap {name} rank {r['rank']}: {r}")
            launches["colsum"] += both[1]
            launches["from_sums"] += both[2]
        r = results[0]
        if "profile" in r:
            show_profile(name, r["profile"], n_layers, r["step"],
                         r["ranks"])
        worst = dp_epoch.worst_change(
            read_wts(init_wts), read_wts(one[dtype]),
            read_wts(os.path.join(root, f"{name}.wts")))
        print(f"overlap {name}: {r['ms_per_bunch']:.3f} ms per bunch "
              f"(epoch 2, {r['bunches']} bunches of {r['rows_per_rank']} "
              f"rows per rank); per bunch and rank {calls / bunches:.0f} "
              f"all-reduces, {r['all_reduce_bytes'] / bunches:.0f} bytes; "
              f"split GGD launches {r['ggd_launches_both_epochs'][1]} + "
              f"{r['ggd_launches_both_epochs'][2]} per rank for 2 x "
              f"{bunches} bunches; weight changes within {worst:.3e} of one "
              f"process ({dtype})")
        bound = TRAIN_DW_RTOL if dtype == "float32" else BF16_TRAIN_DW_RTOL
        if worst > bound:
            raise SystemExit(f"overlap {name}: weight changes {worst:.3e} "
                             f"from one process")
        return r

    # Timed, one cluster at a time, in turns, each traced after its
    # epochs (dp_epoch.PROFILE_BUNCHES bunches).
    for name, n_ranks, gloo, extra in (
            ("nccl1_flat", 1, False, ("--profile",)),
            ("nccl1_overlap", 1, False, ("--overlap", "--profile")),
            ("gloo2_flat", 2, True, ("--profile",)),
            ("gloo2_overlap", 2, True, ("--overlap", "--profile"))):
        finish(name, cluster(name, n_ranks, gloo, *extra))
    # Again, together with the bfloat16 ring on two gloo ranks (gloo sums
    # bfloat16 on the host); then the bfloat16 ring on one NCCL rank.
    bf16 = ("--overlap", "--compute-dtype", "bfloat16")
    again = {name: cluster(name, n, gloo, *extra)
             for name, n, gloo, extra in (
                 ("nccl1_overlap_again", 1, False, ("--overlap",)),
                 ("gloo2_overlap_again", 2, True, ("--overlap",)),
                 ("gloo2_overlap_bf16", 2, True, bf16))}
    for name, ranks in again.items():
        if name.endswith("_bf16"):
            finish(name, ranks, "bfloat16")
            continue
        finish(name, ranks)
        first = name[:-len("_again")]
        same = same_bytes(os.path.join(root, f"{first}.wts"),
                          os.path.join(root, f"{name}.wts"))
        print(f"overlap {first} rerun byte-identical = {same}")
        if not same:
            raise SystemExit(f"overlap {first}: rerun differs")
    finish("nccl1_overlap_bf16", cluster("nccl1_overlap_bf16", 1, False,
                                         *bf16), "bfloat16")
    return launches


def overlap_phase(dev, root: str, train: dict) -> dict:
    """-> the GGD kernels' launches on the overlapped paths, and the
    optimizer kernel's at ``mesh=None`` (one per fused GGD launch there)
    and on the NCCL rank of ``overlap_mesh_runs``."""
    t0 = time.perf_counter()
    os.makedirs(root)
    fused = overlap_unsharded(dev, train["tfx"], train["init_wts"])
    launches = overlap_runs(root, train)
    nccl = overlap_mesh_runs(root, train, 1, ("float32", "bfloat16"), True,
                             "overlap NCCL")
    for key in ("colsum", "from_sums"):
        launches[key] += nccl[key]
    launches["fused"] += fused
    launches["sgd"] = fused + nccl["sgd"]
    print(f"overlap overlapped-step phase wall time: "
          f"{time.perf_counter() - t0:.2f} s")
    return launches


def examples_phase(root: str, fx: dict) -> dict:
    """Both example scripts on the card: ``serve_streaming`` on the slice
    phase's longest utterance with its model (LPS launches counted), and
    ``demo_pipeline`` at full width on a synthetic 14-condition stand-in
    of the demo corpus.  -> LPS and GGD launches."""
    t0 = time.perf_counter()
    os.makedirs(root)
    wav = os.path.join(root, "noisy.wav")
    noisy = fx["waves"][-1]
    write_wav(wav, noisy, SAMPLE_RATE)
    lps_kernel.launches = 0
    streaming.hops_replayed = 0
    t = time.perf_counter()
    got = serve_streaming.serve(wav, fx["wts"], fx["norm"],
                                os.path.join(root, "enhanced_stream.wav"),
                                "cuda", log=lambda s: print(f"example {s}"))
    torch.cuda.synchronize()
    replays, eager = streaming.hops_replayed, lps_kernel.launches
    hops = len(noisy) // SHIFT + got["hops"]
    print(f"example serve_streaming on the card: {time.perf_counter() - t:.2f}"
          f" s; {replays} graph replays (one LPS kernel each) for {hops} "
          f"hops, {eager} lps_cuda calls besides (a warm-up and a capture "
          f"per enhancer)")
    # The batch decode's length: whole hops (T + 1 frames of shift).
    if not (replays == hops and eager == 4
            and len(got["enhanced"]) == len(noisy) // SHIFT * SHIFT):
        raise SystemExit(f"serve_streaming: {replays} replays, {eager} "
                         f"eager LPS calls, {len(got['enhanced'])} samples")
    lps = replays + eager

    reference = write_demo_corpus(os.path.join(root, "demo_ref"),
                                  seconds=DEMO_SECONDS)
    n_train = len(DEMO_CONDITIONS) - 1
    work = os.path.join(root, "demo")
    lps_kernel.launches = 0
    zero_train_counts()
    t = time.perf_counter()
    results = demo_pipeline.run(work, reference, "cuda",
                                log=lambda s: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    lps += lps_kernel.launches
    for r in results:
        print(f"example demo_pipeline {os.path.basename(r['wav'])}: segsnr "
              f"{r['segsnr_noisy']:.2f} -> {r['segsnr']:.2f} dB, lsd "
              f"{r['lsd_noisy']:.2f} -> {r['lsd']:.2f} dB, stoi "
              f"{r['stoi_noisy']:.3f} -> {r['stoi']:.3f}")
        enhanced, _ = read_wav(r["out"])
        values = [r[k] for k in ("segsnr", "segsnr_noisy", "lsd",
                                 "lsd_noisy", "stoi", "stoi_noisy")]
        if not (np.isfinite(values).all() and len(enhanced)):
            raise SystemExit(f"demo_pipeline: {r}")
    trained = glob.glob(os.path.join(work, "MLGGD1", "mlp.*.wts"))
    # One LPS launch per training wav (noisy and clean) and per decoded
    # utterance; one GGD launch per ML bunch of each epoch.
    bunches = ml_bunches({"noisy": os.path.join(work, "train_noisy.pfile"),
                          "train_sents": f"0-{n_train - 3}",
                          "traincache": TrainConfig.traincache})
    want = (2 * n_train + len(results), 40 * bunches)
    print(f"example demo_pipeline at full width, 40 epochs, "
          f"{len(DEMO_CONDITIONS)} conditions of {DEMO_SECONDS} s: "
          f"{seconds:.2f} s; {len(results)} held out; LPS launches "
          f"{lps_kernel.launches}, ggd_output_grad launches "
          f"{ggd_kernel.launches} ({bunches} ML bunches per epoch; "
          f"{replay_check('demo_pipeline', 40 * bunches)}); "
          f"deleting its {len(trained)} .wts")
    if (len(results) != 1 or len(trained) != 40
            or (lps_kernel.launches, ggd_kernel.launches) != want):
        raise SystemExit(f"demo_pipeline: {len(results)} held out, "
                         f"{len(trained)} .wts, launches (LPS, GGD) "
                         f"{(lps_kernel.launches, ggd_kernel.launches)}, "
                         f"wanted {want}")
    for path in trained:
        os.remove(path)
    print(f"example examples phase wall time: "
          f"{time.perf_counter() - t0:.2f} s")
    return {"lps": lps, "ggd": ggd_kernel.launches}


# The benches phase: each measurement module once, at short settings,
# through its ``main(argv)`` (what ``python -m tpu_se_torch.bench.<name>``
# runs), all in one child process on the card; per module its metric and
# the record's keys printed beside it; the records' launch keys that add
# to the kernel table.
BENCH_RUNS = (
    ("train", ["--reps", "1", "--bunches", "100"]),
    ("train", ["--bf16", "--reps", "1", "--bunches", "50"]),
    ("decode", ["--reps", "2"]),
    ("stream", ["--hops", "300"]),
    ("loader", []),
    ("build", ["--seconds", "4", "--reps", "2"]),
    ("scaling", ["--meshes", "1", "--batch-per-device", "128", "--reps",
                 "1"]),
)
# The child: each run's ``main``, then a line "bench-run <i> <rc> <s>";
# last the optimizer kernel's launches over all runs (no bench compares it
# with the plain update): "bench-sgd <launches>".
BENCH_CHILD = """
import importlib, json, sys, time
from tpu_se_torch.ops import sgd_kernel
for i, (name, argv) in enumerate(json.loads(sys.argv[1])):
    t = time.perf_counter()
    rc = importlib.import_module("tpu_se_torch.bench." + name).main(argv)
    print(f"bench-run {i} {rc} {time.perf_counter() - t:.1f}", flush=True)
print(f"bench-sgd {sgd_kernel.launches}", flush=True)
"""
BENCH_KEYS = {
    "train": ("train_frames_per_sec_per_chip",
              ["ms_per_bunch", "mfu", "idle_share", "launches_per_bunch"]),
    "decode": ("decode_frames_per_sec",
               ["device_only_batched_frames_per_sec",
                "events_batched_frames_per_sec", "mfu",
                "enhance_latency_ms_median", "enhance_latency_ms_p90"]),
    "stream": ("stream_realtime_channels",
               ["device_only_p50_ms_s1", "p99_hop_ms_s1"]),
    "loader": ("loader_read_swap_normalize_MBps", ["vs_baseline"]),
    "build": ("lps_extract_files_per_sec", ["lps_extract", "make_pfile"]),
    "scaling": ("dp_weak_scaling_efficiency", ["detail"]),
}
BENCH_LAUNCHES = {"lps_launches": "lps",
                  "ggd_output_grad_launches": "ggd",
                  "ggd_colsum_launches": "colsum",
                  "ggd_grad_from_sums_launches": "from_sums"}


def benches_phase(root: str) -> dict:
    """Every ``BENCH_RUNS`` module in one child process on the card: each
    must exit 0, print its record as a line of its own (the same as its
    ``--out`` file), headed by its metric, on this card, with every one of
    its own checks held.  -> the kernels' launches in the benches'
    records."""
    t0 = time.perf_counter()
    os.makedirs(root)
    outs = [os.path.join(root, f"{i}.{name}.json")
            for i, (name, _) in enumerate(BENCH_RUNS)]
    runs = [(name, [*argv, "--out", out])
            for (name, argv), out in zip(BENCH_RUNS, outs)]
    text, = wait_ranks([start_rank(
        ["-u", "-c", BENCH_CHILD, json.dumps(runs)],
        os.path.join(root, "benches.log"))], "benches")
    lines = text.splitlines()
    done = {int(i): (rc, s) for _, i, rc, s in
            (line.split() for line in lines if line.startswith("bench-run "))}
    launches = dict.fromkeys(BENCH_LAUNCHES.values(), 0)
    for i, ((name, argv), out) in enumerate(zip(BENCH_RUNS, outs)):
        with open(out) as f:
            rec = json.load(f)
        metric, keys = BENCH_KEYS[name]
        if (done.get(i, ("?",))[0] != "0" or json.dumps(rec) not in lines
                or rec["metric"] != metric
                or rec["device"]["platform"] != "gpu"
                or not all(rec["checks"].values())):
            raise SystemExit(f"bench {name}: {text[-3000:]}")
        for key, kernel in BENCH_LAUNCHES.items():
            launches[kernel] += rec.get(key) or 0
        shown = json.dumps({k: rec[k] for k in keys})
        print(f"bench   {name} {' '.join(argv)}: {metric} {rec['value']} "
              f"{rec['unit']}; {shown}; checks {sorted(rec['checks'])} "
              f"held; {done[i][1]} s")
    sgd = [int(line.split()[1]) for line in lines
           if line.startswith("bench-sgd ")]
    if len(sgd) != 1 or sgd[0] < launches["ggd"]:
        raise SystemExit(f"benches: optimizer kernel launches {sgd} against "
                         f"{launches['ggd']} fused GGD launches")
    launches["sgd"] = sgd[0]
    print(f"bench   benches phase wall time: {time.perf_counter() - t0:.2f} "
          f"s; launches {launches}")
    return launches


def main() -> int:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card    {card}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _, log = load_library()
    print(f"build   nvcc sm_90a: {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build   {line.strip()}")

    tensor_core_check()

    with tempfile.TemporaryDirectory() as root:
        fx = write_fixtures(root)
        ts = [len(w) // SHIFT - 1 for w in fx["waves"]]
        kern = kernel_phase(dev, ts + [len(ts) * max(ts)])
        launches = slice_phase(root, fx)
        decode_fps(dev, fx)
        ggd = ggd_phase(dev)
        sgd = sgd_phase(dev)
        train = train_phase(dev, root)
        graph_launches, graph_split = train_graph_child(root)
        native_phase(dev, os.path.join(root, "native"), train)
        pipe = pipeline_phase(os.path.join(root, "pipeline"),
                              train["quiet"])
        stream_launches, fp32_hops = stream_phase(root, fx)
        bf16 = bf16_phase(dev, os.path.join(root, "bf16"), fx, train,
                          fp32_hops)
        dp = dp_phase(dev, os.path.join(root, "dp"), train)
        over = overlap_phase(dev, os.path.join(root, "overlap"), train)
        tp = tp_phase(os.path.join(root, "tp"), train)
        mesh_lps, decoded = mesh_decode_phase(os.path.join(root, "mesh"),
                                              fx)
        cards = cards_phase(os.path.join(root, "cards"), fx, train, decoded)
        examples = examples_phase(os.path.join(root, "examples"), fx)
        benches = benches_phase(os.path.join(root, "benches"))

    # Launches: over the decode, streaming (graph replays included),
    # pipeline, bfloat16, decoder-mesh, cross-card, example and bench
    # paths; over the training, pipeline, bfloat16, overlapped-step (at
    # mesh=None and the one-process references), cross-card (dp_epoch's one
    # process), example and bench paths; the split kernels' over the
    # data-parallel, overlapped-step, tensor-parallel, cross-card and
    # scaling bench paths.  Device time (CUDA-graph replay) at the main path's
    # shapes: the batched decode's rows, the parity bunch.  The split entry
    # points' launches are the child ranks' own counts (one rank over NCCL,
    # two ranks over gloo twice), their times those of a bunch's 128 rows
    # on one rank.  The optimizer kernel's launches are one per trained
    # bunch on every path that trains on the card: the one-device runs
    # (each phase's GGD launches, held equal to its updates by
    # ``update_check``), the ranks' own counts (data-parallel,
    # tensor-parallel and cross-card training runs) and the benches'
    # child; its time is the full-width update's.
    # No kernel's function is one PyTorch call (``torch.optim.SGD(fused=
    # True)`` keeps lr outside the velocity and adds the decay before the
    # momentum: another formula), so there is no library time.
    print(json.dumps({"kernels": [{
        "name": "lps_forward", "route": "cuda",
        "source": "tpu_se_torch/csrc/lps_kernel.cu",
        "replaces": "tpu_se/ops/lps_kernel.py:61",
        "launches": (launches + stream_launches + pipe["lps_launches"]
                     + bf16["lps_launches"] + mesh_lps + cards["lps"]
                     + examples["lps"] + benches["lps"]),
        "max_abs_err": kern["max_abs_err"],
        **kern["times"][len(ts) * max(ts)], "library_ms": None}, {
        "name": "ggd_output_grad", "route": "cuda",
        "source": "tpu_se_torch/csrc/ggd_kernel.cu",
        "replaces": "tpu_se/ops/ggd_kernel.py:50",
        "launches": (train["launches"] + graph_launches
                     + pipe["ggd_launches"]
                     + bf16["ggd_launches"] + over["fused"]
                     + cards["fused"] + examples["ggd"] + benches["ggd"]),
        "max_abs_err": ggd["max_abs_err"],
        **ggd["times"][BUNCH], "library_ms": None}, {
        "name": "ggd_colsum", "route": "cuda",
        "source": "tpu_se_torch/csrc/ggd_kernel.cu",
        "replaces": "tpu_se/ops/ggd_kernel.py:50",
        "launches": (dp["launches"]["colsum"] + over["colsum"]
                     + tp["colsum"] + cards["colsum"] + benches["colsum"]
                     + graph_split),
        "max_abs_err": dp["max_abs_err"]["colsum"],
        **dp["times"][BUNCH]["colsum"], "library_ms": None}, {
        "name": "ggd_grad_from_sums", "route": "cuda",
        "source": "tpu_se_torch/csrc/ggd_kernel.cu",
        "replaces": "tpu_se/ops/ggd_kernel.py:50",
        "launches": (dp["launches"]["from_sums"] + over["from_sums"]
                     + tp["from_sums"] + cards["from_sums"]
                     + benches["from_sums"] + graph_split),
        "max_abs_err": dp["max_abs_err"]["from_sums"],
        **dp["times"][BUNCH]["from_sums"], "library_ms": None}, {
        "name": "sgd_momentum_update", "route": "cuda",
        "source": "tpu_se_torch/csrc/sgd_kernel.cu",
        "replaces": "tpu_se/train/optim.py:23",
        "launches": (train["launches"] + graph_launches
                     + pipe["ggd_launches"] + bf16["ggd_launches"]
                     + over["sgd"] + examples["ggd"] + benches["sgd"]
                     + dp["launches"]["sgd"] + tp["sgd"] + cards["sgd"]
                     + graph_split),
        "max_abs_err": sgd["max_abs_err"], **sgd["times"],
        "library_ms": None}]}))
    print(f"card    {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cards_costs() -> int:
    """``python chip_smoke.py --cards-costs``, on a machine with 2 or more
    cards: the cross-card phase's timed runs alone, with the fixtures they
    need.  The decoder meshes against the one-process card decode and the
    decoders' rates (``card_decode_runs``), then ``dp_epoch`` in one
    process and at every training mesh over NCCL that the cards hold (one
    rank and ``CARD_EPOCH``), each replayed against its eager loop in the
    same ranks and traced on every rank (``card_epoch_times``); and on four
    cards the overlapped step at 4x1 replayed against its eager loop and
    timed beside the flat step, every rank traced (``overlap_mesh_runs``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    print(f"card    {card_line()}")
    load_library()
    with tempfile.TemporaryDirectory() as root:
        fx = write_fixtures(root)
        problem, _ = mesh_problem(root, fx)
        lps_kernel.launches = 0
        one = decode_all(fx["wts"], fx["norm"], problem, None, "cuda")
        torch.cuda.synchronize()
        card_decode_runs(root, fx, one, lps_kernel.launches)
        tfx = write_train_fixtures(root, SEED)
        init_wts = os.path.join(root, "init.wts")
        if cli_main(["gen-rand-net", "-o", init_wts, "--seed",
                     str(SEED)]) != 0:
            raise SystemExit("gen-rand-net failed")
        train = {"tfx": tfx, "init_wts": init_wts}
        meshes = ((1, 1),) + CARD_EPOCH
        card_epoch_times(root, train, shapes=(None,) + meshes,
                         profile=meshes)
        if torch.cuda.device_count() >= CARD_OVERLAP:
            overlap_mesh_runs(root, train, CARD_OVERLAP, ("float32",), True,
                              "cards")
    return 0


if __name__ == "__main__":
    sys.exit(cards_costs() if sys.argv[1:] == ["--cards-costs"] else main())
