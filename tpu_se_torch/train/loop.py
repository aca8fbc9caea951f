"""The epoch loop: the ``finetune.pl`` + ``BPtrain.cc`` equivalent.

Port of ``tpu_se/train/loop.py``, for one device or a mesh of them (one
process per device, ``tpu_se_torch.parallel``).  Epoch protocol
(``finetune.pl:10-155``, ``BPtrain.cc:55-146``):

- epoch N trains from epoch N-1's weights; lr constant for epochs 1..10,
  then *= 0.9 per epoch; seed = init_seed + 345*(epoch-1);
- resume-by-existence: an epoch whose ``mlp.N.wts`` exists is skipped;
  with ``checkpoint_every_chunks`` an epoch also resumes mid-way from its
  chunk-stamped partial checkpoint, replaying the shuffle draws;
- momentum velocity resets at each epoch boundary unless
  ``carry_velocity``;
- per-epoch CV metrics: squared error, abs error, GGD log-likelihood.

The shuffles come from the same ``np.random.Generator`` draws as in
``tpu_se``, so both packages train on the same bunches in the same order.

Under a mesh (``TrainConfig.coordinator`` or ``TrainConfig.mesh``, data x
model ranks): every rank runs the same schedule and draws the same
shuffles; a rank trains the M / data rows of its data index of every bunch
(``train_chunk(mesh=)``) on its ``TensorParallelFFN`` shard of the model
(the whole model with a model axis of one), reads 1 / P of the resident
span from storage, and runs the whole CV.  Only rank 0 writes ``.wts``,
partial checkpoints and logs, of whole tensors gathered over the model
axis; a barrier after each epoch keeps resume-by-existence consistent on
shared storage, and there the ranks compare their replicas and shards and
raise if they have drifted apart.
"""

from __future__ import annotations

import glob
import json
import math
import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from tpu_se_torch.data import PfilePairDataset, PrefetchIterator
from tpu_se_torch.io import atomic_write, read_wts
from tpu_se_torch.losses import ref_gamma
from tpu_se_torch.models import (
    DEFAULT_LAYERSIZES, init_params, init_params_uniform,
)
from tpu_se_torch.ops import ggd_kernel, sgd_kernel
from tpu_se_torch.parallel import (
    Mesh, MeshConfig, initialize_distributed, launch_local_ranks, make_mesh,
    shard_train_args, shutdown_distributed, sync_processes,
)
from tpu_se_torch.parallel.distributed import allgather_rows
from tpu_se_torch.parallel.mesh import AXES, check_mesh_devices, free_port
from tpu_se_torch.parallel.tensor import check_model_split
from tpu_se_torch.train.checkpoint import (
    load_checkpoint, model_from_layers, save_checkpoint,
)
from tpu_se_torch.train import step as step_mod
from tpu_se_torch.train.step import (
    TrainHyper, TrainState, cv_chunk_metrics, make_train_state, train_chunk,
)
from tpu_se_torch.utils import EpochLogger, resolve_device

CV_BATCH = 4096


@dataclass
class TrainConfig:
    """The reference's config keys (``Interface.cc:150-315``) plus the
    framework's knobs, as ``tpu_se.train.TrainConfig`` has them.
    Checkpoints and ``.wts`` files are float32 whatever ``compute_dtype``
    says.

    Data and tensor parallel, one process per device.  Set ``coordinator``
    (``"host:port"`` of rank 0), ``num_processes`` and ``process_id`` on
    every rank to join a ``torch.distributed`` group: NCCL for a CUDA
    device, gloo for the CPU, gloo for both with
    ``cpu_collectives="gloo"``; ``mesh=MeshConfig(data, model)`` then names
    the model axis (the data axis is the rest of the group).  Or set
    ``mesh`` alone and ``run_training`` starts the data x model ranks of
    this host itself."""

    fea_file: str = ""
    targ_file: str = ""
    norm_file: str = ""
    init_wts_file: str = ""          # empty -> random init
    out_dir: str = "mlp_out"
    layersizes: tuple = DEFAULT_LAYERSIZES
    bunchsize: int = 128
    ml_flag: bool = True
    shapefactor: float = 1.0
    momentum: float = 0.9
    weightcost: float = 1e-5
    lrate: float = 0.1
    fea_dim: int = 257
    fea_context: int = 7
    traincache: int = 102400
    init_seed: int = 27870775
    targ_offset: int = 3
    train_sent_range: tuple = (0, 7)
    cv_sent_range: tuple = (8, 9)
    epochs: int = 50
    lr_const_epochs: int = 10
    lr_decay: float = 0.9
    seed_increment: int = 345
    grad_scale: str = "parity"
    compute_dtype: str = "float32"   # or "bfloat16"
    carry_velocity: bool = False
    # init_randem_{weight,bias}_{min,max} (Interface.cc:140-143): when set
    # (and no init_wts_file), plain uniform init from these ranges.
    init_ranges: tuple | None = None  # (w_min, w_max, b_min, b_max)
    activation: str = "sigmoid"      # "relu" = the reference's RELU build
    dropout_flag: bool = False       # dropoutflag (finetune.pl:74-76)
    visible_omit: float = 0.1
    hid_omit: float = 0.1
    device_resident: str = "auto"    # "auto" | "always" | "never"
    device_resident_max_bytes: int = 4 << 30
    checkpoint_every_chunks: int = 0  # >0: mid-epoch partial checkpoints
    mesh: MeshConfig | None = None   # requested mesh shape
    coordinator: str = ""
    num_processes: int | None = None
    process_id: int | None = None
    cpu_collectives: str = ""

    def hyper(self) -> TrainHyper:
        return TrainHyper(
            beta=self.shapefactor, ml=self.ml_flag, momentum=self.momentum,
            weightcost=self.weightcost, bunchsize=self.bunchsize,
            context=self.fea_context, targ_offset=self.targ_offset,
            grad_scale=self.grad_scale, compute_dtype=self.compute_dtype,
            activation=self.activation,
            dropout=((self.visible_omit, self.hid_omit)
                     if self.dropout_flag else None),
        )

    def lr_for_epoch(self, epoch: int) -> float:
        decay_steps = max(0, epoch - self.lr_const_epochs)
        return self.lrate * (self.lr_decay ** decay_steps)

    def seed_for_epoch(self, epoch: int) -> int:
        return self.init_seed + self.seed_increment * (epoch - 1)


def model_sizes(layers: list[dict]) -> tuple:
    """The layer sizes of whole numpy layers (``read_wts``'s)."""
    return (layers[0]["w"].shape[0], *(layer["w"].shape[1]
                                       for layer in layers))


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host numpy -> tensor on ``device``.  A CUDA copy goes through pinned
    memory without blocking the host, so it does not wait for the card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def load_device_frames(dataset: PfilePairDataset, device,
                       mesh: Mesh | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Upload a dataset's normalized frame span to ``device`` (once per
    job): ``train_one_epoch(device_frames=...)`` then moves only window
    starts.

    Under a mesh of several ranks each rank reads only its
    ``shard_for_host`` rows from storage and the span is reassembled by an
    all-gather, byte-identical to the unsharded read: under NCCL on the
    card (the shard is uploaded and gathered where the span is needed),
    under gloo on the host, before the upload.
    """
    device = torch.device(device)
    if mesh is None or mesh.size == 1:
        noisy, clean = dataset.load_span_normalized()
    elif mesh.backend == "nccl":
        lo, hi = dataset.frame_span()
        return tuple(
            allgather_rows(to_device(rows, device), hi - lo, mesh.rank,
                           mesh.size)
            for rows in dataset.load_span_shard(mesh.rank, mesh.size))
    else:
        noisy, clean = dataset.load_span_normalized(
            process_shard=(mesh.rank, mesh.size))
    return to_device(noisy, device), to_device(clean, device)


def dropout_generator(seed: int, chunk: int, device) -> torch.Generator:
    """The dropout masks' generator for one chunk of an epoch: seeded from
    the epoch's draw and the chunk index (as JAX folds the chunk index into
    its key), so a mid-epoch resume draws the same masks.  A new generator
    per chunk costs no capture on a card: the replayed bunch takes its
    seed and offset (``train/step.py``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, chunk])
                        .generate_state(1)[0]))
    return gen


def train_one_epoch(state: TrainState, dataset: PfilePairDataset,
                    hyper: TrainHyper, lr: float, rng: np.random.Generator,
                    device, device_frames=None, log=print,
                    start_chunk: int = 0, ckpt_every: int = 0,
                    ckpt_cb=None, mesh: Mesh | None = None,
                    step=None) -> TrainState:
    """One epoch over the dataset's chunks on ``device``.

    With ``device_frames`` (from ``load_device_frames``) the frames stay on
    the device and each chunk uploads only its ``[n_bunches, M]`` starts;
    without, each chunk's frames are uploaded with them.  ``start_chunk``
    resumes mid-epoch: the skipped chunks' rng draws are replayed (not
    trained).  With ``ckpt_every`` > 0, ``ckpt_cb(state, chunks_done)``
    fires after every N trained chunks.  With ``mesh`` every rank walks the
    same chunks and shuffles and trains its columns of each bunch.
    ``step`` trains one chunk, with ``train_chunk``'s arguments; None is
    ``train_chunk`` (``bench/dp_epoch.py --overlap`` passes the overlapped
    step).
    """
    device = torch.device(device)
    n_chunks = dataset.n_chunks
    # Drawn BEFORE the chunk permutation, exactly where tpu_se draws its
    # dropout key, so every later shuffle stays the JAX package's.
    dropout_seed = (int(rng.integers(2 ** 31))
                    if hyper.dropout is not None else None)
    m = hyper.bunchsize

    def run(i, noisy, clean, starts, tag):
        n_bunches = len(starts) // m
        if n_bunches == 0:
            return
        starts = starts[: n_bunches * m].reshape(n_bunches, m)
        gen = (dropout_generator(dropout_seed, i, device)
               if dropout_seed is not None else None)
        if mesh is not None:
            noisy, clean, starts = shard_train_args(mesh, noisy, clean,
                                                    starts)
        (train_chunk if step is None else step)(
            state, noisy, clean, to_device(starts.astype(np.int64), device),
            lr, hyper, generator=gen, mesh=mesh)
        log(f"  chunk {i+1}/{n_chunks}: {n_bunches} bunches{tag}")
        if ckpt_every and ckpt_cb is not None and (i + 1) % ckpt_every == 0:
            ckpt_cb(state, i + 1)

    if device_frames is not None:
        noisy_dev, clean_dev = device_frames
        for i, starts in enumerate(
                PrefetchIterator(dataset.epoch_chunk_starts(rng))):
            if i >= start_chunk:           # rng already consumed by the gen
                run(i, noisy_dev, clean_dev, starts, " (resident)")
        return state

    for i, chunk in enumerate(
            PrefetchIterator(dataset.epoch_chunks(rng, skip=start_chunk)),
            start=start_chunk):
        run(i, to_device(chunk.noisy, device), to_device(chunk.clean, device),
            chunk.starts, "")
    return state


def evaluate_cv(state: TrainState, cv_dataset: PfilePairDataset,
                hyper: TrainHyper, device, device_frames=None) -> dict:
    """CV metrics over a dataset (sequential order, partial bunches kept;
    ``Interface.cc:841-965`` + ``BP_GPU.cu:187-306``).

    Batches of ``CV_BATCH`` windows; each batch's three float32 sums are
    accumulated into a float64 tensor on the device, which the host reads
    once at the end.
    """
    device = torch.device(device)
    out_dim = cv_dataset.dim
    acc = torch.zeros(3, dtype=torch.float64, device=device)
    n_total = 0

    def accumulate(noisy_dev, clean_dev, starts):
        nonlocal n_total
        for lo in range(0, len(starts), CV_BATCH):
            s = starts[lo:lo + CV_BATCH]
            acc.add_(cv_chunk_metrics(
                state.model, noisy_dev, clean_dev,
                to_device(s.astype(np.int64), device), state.alpha,
                hyper).double())
            n_total += len(s)

    for ci in range(cv_dataset.n_chunks):
        if device_frames is not None:
            accumulate(*device_frames, cv_dataset.chunk_starts(ci))
        else:
            chunk = cv_dataset.chunk(ci)       # no rng -> sequential
            accumulate(to_device(chunk.noisy, device),
                       to_device(chunk.clean, device), chunk.starts)

    sq, ab, sum_pow = acc.tolist()
    alpha = state.alpha.cpu().numpy().astype(np.float64)
    gamma_val = ref_gamma(1.0 / hyper.beta)
    loglik = (n_total * out_dim * math.log(hyper.beta / (2.0 * gamma_val))
              - n_total * float(np.log(alpha).sum()) - sum_pow)
    return {"cv_squared_error": sq, "cv_abs_error": ab / out_dim,
            "cv_ggd_loglik": loglik, "cv_frames": n_total}


def _initial_state(cfg: TrainConfig, device, mesh: Mesh | None
                   ) -> TrainState:
    if cfg.init_wts_file:
        return load_checkpoint(cfg.init_wts_file, device, cfg.activation,
                               mesh)
    if cfg.init_ranges is not None:
        layers = init_params_uniform(cfg.seed_for_epoch(1), cfg.layersizes,
                                     *cfg.init_ranges)
    else:
        layers = init_params(cfg.seed_for_epoch(1), cfg.layersizes)
    return make_train_state(model_from_layers(layers, device, cfg.activation,
                                              mesh))


class _SilentEpochLogger:
    """``EpochLogger`` stand-in for the ranks that write no files."""

    def __call__(self, line: str) -> None:
        pass

    def config(self, cfg) -> None:
        pass

    def finish(self, metrics: dict) -> None:
        pass


def _local_rank(rank: int, cfg: TrainConfig, device_name: str,
                port: int) -> None:
    """One rank of a one-host mesh, in its own spawned process."""
    cfg = replace(cfg, coordinator=f"127.0.0.1:{port}",
                  num_processes=cfg.mesh.n_devices, process_id=rank)
    run_training(cfg, device_name,
                 log=print if rank == 0 else lambda line: None)


def _run_local_mesh(cfg: TrainConfig, device: torch.device, log) -> str:
    """``mesh=MeshConfig(data, model)`` without a coordinator: start the
    data x model ranks of this host (rank k on card k, or CPU ranks) and
    wait for them.  Rank 0 prints the run's lines; the others stay
    quiet."""
    if device.type == "cuda":
        check_mesh_devices(cfg.mesh.data, cfg.mesh.model,
                           torch.cuda.device_count())
    log(f"data mesh: starting {cfg.mesh.n_devices} local ranks on "
        f"{device.type}")
    launch_local_ranks(_local_rank, cfg.mesh.n_devices,
                       (cfg, device.type, free_port()))
    return os.path.join(cfg.out_dir, f"mlp.{cfg.epochs}.wts")


def run_training(cfg: TrainConfig, device, log=print) -> str:
    """Run the full multi-epoch schedule on ``device``; returns the final
    .wts path.  ``device`` is ``"cuda"`` or ``"cpu"`` (``resolve_device``:
    a CUDA request without a card raises).

    With ``cfg.coordinator`` this process is one rank of a mesh (see
    ``TrainConfig``); it leaves the process group when the schedule ends,
    also on an exception.  With ``cfg.mesh`` alone the ranks are started
    here.  A mesh of one rank still takes the mesh's step (the split GGD
    kernel, the collectives, the sharded model's code), with one device's
    bits."""
    device = resolve_device(device)
    if cfg.mesh is not None and cfg.mesh.model > 1:
        check_model_split(
            model_sizes(read_wts(cfg.init_wts_file)) if cfg.init_wts_file
            else cfg.layersizes, cfg.mesh.model)
    if not cfg.coordinator:
        if cfg.mesh is not None and cfg.mesh.n_devices > 1:
            return _run_local_mesh(cfg, device, log)
        return _run_schedule(cfg, device, None, log)
    info = initialize_distributed(
        cfg.coordinator, cfg.num_processes, cfg.process_id,
        cfg.cpu_collectives or None, device)
    try:
        # Under a coordinator the data axis is the rest of the group.
        mesh = make_mesh(
            cfg.mesh.data if cfg.mesh is not None and cfg.mesh.data > 1
            else None, cfg.mesh.model if cfg.mesh is not None else 1,
            info["device"])
        log(f"data mesh: data={mesh.data}, model={mesh.model}, rank "
            f"{mesh.rank} on {mesh.device} ({mesh.backend})")
        return _run_schedule(cfg, mesh.device, mesh, log)
    finally:
        shutdown_distributed()


def _run_schedule(cfg: TrainConfig, device: torch.device, mesh: Mesh | None,
                  log) -> str:
    is_main = mesh is None or mesh.rank == 0
    replica_checks = 0
    if mesh is not None and cfg.bunchsize % mesh.data != 0:
        raise ValueError(f"bunchsize {cfg.bunchsize} does not split evenly "
                         f"over {mesh.data} ranks of the data axis")
    os.makedirs(cfg.out_dir, exist_ok=True)
    hyper = cfg.hyper()

    dataset = PfilePairDataset(
        cfg.fea_file, cfg.targ_file, cfg.norm_file, cfg.train_sent_range,
        cfg.traincache, cfg.fea_context, cfg.targ_offset)
    cv_dataset = PfilePairDataset(
        cfg.fea_file, cfg.targ_file, cfg.norm_file, cfg.cv_sent_range,
        cfg.traincache, cfg.fea_context, cfg.targ_offset)

    def resident(ds):
        if cfg.device_resident == "never":
            return None
        if (cfg.device_resident == "auto"
                and ds.span_bytes() > cfg.device_resident_max_bytes):
            return None
        return load_device_frames(ds, device, mesh)

    train_frames = resident(dataset)
    cv_frames = resident(cv_dataset)
    if train_frames is not None:
        log(f"train span resident on {device} "
            f"({dataset.span_bytes() / 1e6:.0f} MB)")

    last_path = ""
    state = None          # in-memory state carried across epochs
    for epoch in range(1, cfg.epochs + 1):
        out_path = os.path.join(cfg.out_dir, f"mlp.{epoch}.wts")
        if os.path.exists(out_path):
            log(f"epoch {epoch}: {out_path} exists, skipping (resume)")
            last_path = out_path
            state = None  # must reload from disk when training resumes
            continue

        if epoch == 1:
            state = _initial_state(cfg, device, mesh)
        else:
            if state is None:
                state = load_checkpoint(last_path, device, cfg.activation,
                                        mesh)
            if not cfg.carry_velocity:
                state = make_train_state(state.model)

        # Mid-epoch resume.  Partial checkpoints are chunk-stamped
        # (mlp.N.partial.<k>.wts + sidecar) and committed by an atomic
        # rename of the meta file naming <k>, written only after both are
        # complete: a crash at any point leaves the meta pointing at a
        # self-consistent (weights, velocity, alpha, position) set.
        partial_stem = os.path.join(cfg.out_dir, f"mlp.{epoch}.partial")
        meta_path = f"{partial_stem}.wts.meta.json"
        start_chunk = 0
        if cfg.checkpoint_every_chunks and os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("epoch") == epoch:
                start_chunk = int(meta["chunks_done"])
                pp = f"{partial_stem}.{start_chunk}.wts"
                if os.path.exists(pp):
                    state = load_checkpoint(pp, device, cfg.activation, mesh)
                    log(f"epoch {epoch}: resuming mid-epoch at chunk "
                        f"{start_chunk} from {pp}")
                else:
                    start_chunk = 0
                    log(f"epoch {epoch}: partial meta found but no "
                        f"checkpoint file; restarting epoch")

        def partial_files(_stem=partial_stem):
            return glob.glob(f"{_stem}.*")

        def save_partial(st, chunks_done, _epoch=epoch, _stem=partial_stem,
                         _mp=meta_path):
            pp = f"{_stem}.{chunks_done}.wts"
            save_checkpoint(pp, st, mesh=mesh)
            if not is_main:
                return
            atomic_write(_mp, lambda f: json.dump(
                {"epoch": _epoch, "chunks_done": chunks_done}, f),
                mode="w")   # the rename is the commit point
            for p in partial_files(_stem):
                if (not p.endswith(".meta.json")
                        and f".{chunks_done}.wts" not in p):
                    os.remove(p)

        lr = cfg.lr_for_epoch(epoch)
        rng = np.random.default_rng(cfg.seed_for_epoch(epoch))
        elog = (EpochLogger(cfg.out_dir, epoch) if is_main
                else _SilentEpochLogger())
        elog(f"epoch {epoch} lr={lr:.6g} seed={cfg.seed_for_epoch(epoch)}")
        elog.config(cfg)
        t0 = time.time()
        state = train_one_epoch(
            state, dataset, hyper, lr, rng, device,
            device_frames=train_frames, log=elog, start_chunk=start_chunk,
            ckpt_every=cfg.checkpoint_every_chunks,
            ckpt_cb=save_partial if cfg.checkpoint_every_chunks else None,
            mesh=mesh)
        metrics = evaluate_cv(state, cv_dataset, hyper, device,
                              device_frames=cv_frames)
        dt = time.time() - t0
        if mesh is not None:
            state.model.check_replicas(f"at the end of epoch {epoch}")
            replica_checks += 1
        # Velocity resets each epoch under the parity schedule, so the
        # sidecar only matters when it carries across epochs.
        save_checkpoint(out_path, state, with_state=cfg.carry_velocity,
                        mesh=mesh)
        if is_main:
            for p in partial_files():
                os.remove(p)
        # No rank starts epoch N+1 (or, resuming, looks for this epoch's
        # .wts on shared storage) before rank 0 has written it.
        sync_processes(f"epoch-{epoch}")
        elog.finish(metrics)
        log(f"epoch {epoch}: sq={metrics['cv_squared_error']:.1f} "
            f"abs={metrics['cv_abs_error']:.1f} "
            f"ll={metrics['cv_ggd_loglik']:.1f} ({dt:.1f}s)")
        last_path = out_path
    if mesh is not None:
        log(f"data mesh: rank {mesh.rank} of {mesh.size} ({mesh.backend}): "
            f"ggd_colsum {ggd_kernel.colsum_launches} launches, "
            f"ggd_grad_from_sums {ggd_kernel.grad_from_sums_launches} "
            f"launches, sgd_momentum_update {sgd_kernel.launches} launches, "
            f"{traffic_text(mesh)}, replicas equal at "
            f"{replica_checks} epoch ends; {step_mod.bunches_replayed} "
            f"bunches replayed after {step_mod.graphs_captured} captures")
    return last_path


def traffic_text(mesh: Mesh) -> str:
    """What this rank's collectives moved, per axis: ``data axis all_reduce
    N calls B bytes all_gather N calls B bytes; model axis ...``."""
    return "; ".join(
        f"{axis} axis " + " ".join(
            f"{op} {calls} calls {sent} bytes"
            for op, (calls, sent) in mesh.traffic[axis].items())
        for axis in AXES)
