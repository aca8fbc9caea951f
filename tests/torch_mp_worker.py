"""Test worker: one rank of a ``torch.distributed`` gloo cluster on the CPU.

Launched by ``tests/test_torch_parallel.py`` and
``tests/test_torch_distributed.py`` as

    python tests/torch_mp_worker.py <mode> <rank> <n_ranks> <port> <dir> ...

once per rank; every rank joins ``tcp://127.0.0.1:<port>`` through
``tpu_se_torch.parallel.initialize_distributed`` and leaves its result in
``<dir>``.  It imports no JAX.  ``run_ranks`` is the launcher those tests
use: it starts the ranks, bounds their time and kills what is left.
Modes:

- ``allgather``: ``allgather_host_rows`` on an uneven row shard of a
  seeded array; every rank saves what it got (``gathered.<rank>.npy``).
- ``span <fea> <targ> <norm>``: ``load_span_normalized(process_shard=)``
  and ``load_device_frames(mesh=)`` of sentences 0-7; every rank saves
  both (``span.<rank>.npz``).
- ``chunk <ml> <beta>``: one ``train_chunk(mesh=)`` over the problem in
  ``<dir>/problem.npz`` (written by the test, so JAX and every rank see the
  same numbers); rank 0 saves weights, velocity and alpha
  (``chunk.npz``).
- ``replicas``: rank 1 moves one weight by one ulp, then every rank calls
  ``Mesh.check_replicas``; exit code 5 when it raised as it must.
- ``axes``: a 2 x 2 mesh; every rank sums and gathers its rank over each
  axis (the model axis' gather in int16), checks replicas that are equal
  along the data axis and then ones that differ across the model axis,
  and saves what it got (``axes.<rank>.npz``).
- ``tp <model> <names...>``: a ``data`` x ``model`` mesh over the ranks;
  for each ``<dir>/tp_<name>.npz`` problem (written by the test) the
  sharded forward of its ``x`` (each data index its rows, with and
  without dropout) and one ``train_chunk`` per ``ml`` in {1, 0} (and in
  bfloat16 when the problem asks), from ``shard_params`` of its layers;
  rank 0 saves the gathered outputs, weights, velocity, alpha and the
  collectives' traffic (``tp_<name>.out.npz``).
- ``overlap``: the overlapped step ``train_chunk_overlap(mesh=)`` and the
  flat ``train_chunk(mesh=)``, in float32 for ``ml`` in {1, 0} on
  ``<dir>/problem.npz`` (as ``chunk``) and in bfloat16 (``ml`` 1,
  ``grad_scale`` natural) on ``<dir>/problem_bf16.npz``; and
  ``Mesh.all_reduce_sum_async`` of a bfloat16 and a float32 tensor at
  once; rank 0 saves weights, alpha and each run's collectives
  (``overlap.npz``).
- ``decode``: ``tpu_se_torch.bench.mesh_decode.decode_all`` on
  ``<dir>/decode.npz`` (written by the test) with a data mesh over the
  ranks; every rank saves what it returned (``decode.<rank>.npz``).
- ``train <args...>``: the ``tpu_se_torch train`` CLI as this rank, hard
  killed (``os._exit(7)``: no cleanup, as SIGKILL) after
  ``TPU_SE_TORCH_CRASH_AFTER_CHUNKS`` ``train_chunk`` dispatches when that
  is set: the twin of ``tests/mp_crash_worker.py``.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tpu_se_torch.data import PfilePairDataset, shard_for_host  # noqa: E402
from tpu_se_torch.models import params_from_numpy  # noqa: E402
from tpu_se_torch.parallel import (  # noqa: E402
    allgather_host_rows, gather_params, initialize_distributed, make_mesh,
    shard_params, shard_train_args, shutdown_distributed,
)
from tpu_se_torch.parallel.tensor import gather_layers  # noqa: E402
from tpu_se_torch.train import (  # noqa: E402
    TrainHyper, load_device_frames, make_train_state, param_layers,
    train_chunk,
)

GATHER_ROWS = 11          # not a multiple of 2 or 3: uneven shards
TIMEOUT_S = 60.0          # a dead peer ends the rank


def run_ranks(argv_for_rank, n_ranks: int, timeout: float = 120.0,
              env: dict | None = None, expect_failure: bool = False):
    """Start ``python <argv_for_rank(k)>`` for k < n_ranks and wait for all
    of them -> (exit codes, outputs).  The cluster gets ``timeout`` seconds
    in all; when it runs out, or (unless ``expect_failure``) when one rank
    has failed and the others have had 10 s to follow, every rank still
    alive is killed and ``RuntimeError`` is raised with the outputs.  No
    child survives the call."""
    full_env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    full_env.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, *argv_for_rank(k)], env=full_env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(n_ranks)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed and not expect_failure:
                deadline = min(deadline, time.monotonic() + 10.0)
                expect_failure = True        # shorten the deadline once
            if time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                logs = [p.communicate()[0] for p in procs]
                raise RuntimeError(
                    f"ranks did not end in time (exit codes "
                    f"{[p.returncode for p in procs]}):\n"
                    + "\n----\n".join(logs))
            time.sleep(0.05)
        return ([p.returncode for p in procs],
                [p.communicate()[0] for p in procs])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def write_decode_problem(where) -> dict:
    """A (1799, 32, 32, 257) model, its ``.norm``, three int16 waves and
    8 streams of 12 hops, as ``tests/test_parallel.py:116-242`` makes them,
    written to ``where`` (``m.wts``, ``m.norm``, ``decode.npz``)."""
    from tpu_se_torch.io import write_norm, write_wts
    from tpu_se_torch.models import init_params

    write_wts(os.path.join(where, "m.wts"),
              init_params(11, (1799, 32, 32, 257)))
    rng = np.random.default_rng(2)
    write_norm(os.path.join(where, "m.norm"),
               rng.normal(size=257).astype(np.float32),
               (0.5 + rng.random(257)).astype(np.float32))
    waves = [(rng.normal(size=n) * 3000).astype(np.int16)
             for n in (8000, 12000, 5000)]
    problem = {"waves": np.concatenate(waves),
               "lengths": np.array([len(w) for w in waves]),
               "hops": (rng.normal(size=(8, 12, 256)) * 3000).astype(
                   np.int16)}
    np.savez(os.path.join(where, "decode.npz"), **problem)
    return problem


def run_decode_cluster(where, n_ranks: int) -> list[dict]:
    """``decode`` mode over ``n_ranks`` gloo ranks -> what each returned."""
    from tpu_se_torch.parallel.mesh import free_port

    port = free_port()
    codes, logs = run_ranks(
        lambda k: [os.path.abspath(__file__), "decode", str(k), str(n_ranks),
                   str(port), str(where)], n_ranks, timeout=180)
    if codes != [0] * n_ranks:
        raise RuntimeError("\n".join(logs))
    out = []
    for rank in range(n_ranks):
        with np.load(os.path.join(where, f"decode.{rank}.npz")) as z:
            out.append(dict(z))
    return out


def gather_problem() -> np.ndarray:
    return np.random.default_rng(5).standard_normal(
        (GATHER_ROWS, 3)).astype(np.float32)


def run_allgather(rank, n_ranks, out_dir):
    full = gather_problem()
    mine = full[shard_for_host(GATHER_ROWS, rank, n_ranks)]
    got = allgather_host_rows(mine, GATHER_ROWS, rank, n_ranks)
    np.save(os.path.join(out_dir, f"gathered.{rank}.npy"), got)


def run_span(rank, n_ranks, out_dir, fea, targ, norm):
    ds = PfilePairDataset(fea, targ, norm, (0, 7), 512)
    noisy, clean = ds.load_span_normalized(process_shard=(rank, n_ranks))
    dev_noisy, dev_clean = load_device_frames(ds, "cpu",
                                              make_mesh(device="cpu"))
    np.savez(os.path.join(out_dir, f"span.{rank}.npz"), noisy=noisy,
             clean=clean, dev_noisy=dev_noisy.numpy(),
             dev_clean=dev_clean.numpy())


def run_chunk(rank, n_ranks, out_dir, ml, beta):
    with np.load(os.path.join(out_dir, "problem.npz")) as z:
        problem = dict(z)
    n_layers = sum(1 for k in problem if k.startswith("w"))
    layers = [{"w": problem[f"w{i}"], "b": problem[f"b{i}"]}
              for i in range(n_layers)]
    hyper = TrainHyper(beta=float(beta), ml=ml == "1",
                       bunchsize=int(problem["starts"].shape[1]),
                       context=int(problem["context"]),
                       targ_offset=int(problem["targ_offset"]))
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (rank, n_ranks)
    state = make_train_state(params_from_numpy(layers, "cpu"))
    noisy, clean, starts = shard_train_args(
        mesh, torch.from_numpy(problem["noisy"]),
        torch.from_numpy(problem["clean"]),
        torch.from_numpy(problem["starts"].astype(np.int64)))
    train_chunk(state, noisy, clean, starts, float(problem["lr"]), hyper,
                mesh=mesh)
    mesh.check_replicas(list(state.model.parameters()), "after the chunk")
    if rank == 0:
        out = {"alpha": state.alpha.numpy(),
               "all_reduce_calls": mesh.all_reduce_calls}
        for i, (p, v) in enumerate(zip(param_layers(state.model),
                                       state.velocity)):
            for k in ("w", "b"):
                out[f"{k}{i}"] = p[k].detach().numpy()
                out[f"vel_{k}{i}"] = v[k].numpy()
        np.savez(os.path.join(out_dir, "chunk.npz"), **out)


def run_overlap(rank, n_ranks, out_dir):
    from tpu_se_torch.parallel.overlap_step import (
        shard_overlap_args, train_chunk_overlap,
    )

    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (rank, n_ranks)
    out = {}
    for case, ml, dtype, scale, name in (
            ("ml1", True, "float32", "parity", "problem"),
            ("ml0", False, "float32", "parity", "problem"),
            ("bf16", True, "bfloat16", "natural", "problem_bf16")):
        problem, layers = _load(os.path.join(out_dir, f"{name}.npz"))
        hyper = TrainHyper(beta=1.0, ml=ml,
                           bunchsize=int(problem["starts"].shape[1]),
                           context=int(problem["context"]),
                           targ_offset=int(problem["targ_offset"]),
                           compute_dtype=dtype, grad_scale=scale)
        for step, fn in (("overlap", train_chunk_overlap),
                         ("flat", train_chunk)):
            state = make_train_state(params_from_numpy(layers, "cpu"))
            noisy, clean, starts = shard_overlap_args(
                mesh, torch.from_numpy(problem["noisy"]),
                torch.from_numpy(problem["clean"]),
                torch.from_numpy(problem["starts"].astype(np.int64)))
            calls, sent = mesh.traffic["data"]["all_reduce"]
            fn(state, noisy, clean, starts, float(problem["lr"]), hyper,
               mesh=mesh)
            mesh.check_replicas(list(state.model.parameters()),
                                "after the chunk")
            after = mesh.traffic["data"]["all_reduce"]
            out[f"{case}_{step}_traffic"] = np.array(
                [after[0] - calls, after[1] - sent])
            out[f"{case}_{step}_alpha"] = state.alpha.numpy()
            for i, p in enumerate(param_layers(state.model)):
                for k in ("w", "b"):
                    out[f"{case}_{step}_{k}{i}"] = p[k].detach().numpy()
    # Two sums in flight at once, one of them in bfloat16.
    half = torch.tensor([1.0, 2.0 ** -8, 3.0, -0.5],
                        dtype=torch.bfloat16) * (rank + 1)
    full = torch.arange(5, dtype=torch.float32) * (rank + 1)
    pending = [mesh.all_reduce_sum_async(half.clone(), slot="half"),
               mesh.all_reduce_sum_async(full.clone(), slot="full")]
    out["bf16_sum"], out["f32_sum"] = (
        p.wait().float().numpy() for p in pending)
    if rank == 0:
        np.savez(os.path.join(out_dir, "overlap.npz"), **out)


def _load(path):
    with np.load(path) as z:
        problem = dict(z)
    n_layers = sum(1 for k in problem if k[0] == "w" and k[1:].isdigit())
    layers = [{"w": problem[f"w{i}"], "b": problem[f"b{i}"]}
              for i in range(n_layers)]
    return problem, layers


def _tp_forward(mesh, model, x, **kw):
    """The whole batch's outputs: each data index forwards its rows."""
    per = x.shape[0] // mesh.data
    mine = x[mesh.data_rank * per:(mesh.data_rank + 1) * per]
    with torch.no_grad():
        out = model(mine, dropout_rows=(mesh.data_rank * per, x.shape[0]),
                    **kw)
    return mesh.all_gather(out, 0, "data").numpy()


def run_tp(rank, n_ranks, out_dir, model_axis, *names):
    mesh = make_mesh(None, int(model_axis), device="cpu")
    assert (mesh.rank, mesh.size, mesh.model) == (rank, n_ranks,
                                                  int(model_axis))
    for name in names:
        problem, layers = _load(os.path.join(out_dir, f"tp_{name}.npz"))
        out = {}
        model = shard_params(layers, mesh)
        x = torch.from_numpy(problem["x"])
        out["forward"] = _tp_forward(mesh, model, x)
        out["dropout"] = _tp_forward(
            mesh, model, x, dropout=(0.2, 0.5),
            generator=torch.Generator().manual_seed(77))
        cases = [("ml1", True, "float32"), ("ml0", False, "float32")]
        if "bf16" in problem:
            cases.append(("bf16", True, "bfloat16"))
        for case, ml, dtype in cases:
            hyper = TrainHyper(beta=1.0, ml=ml,
                               bunchsize=int(problem["starts"].shape[1]),
                               context=int(problem["context"]),
                               targ_offset=int(problem["targ_offset"]),
                               compute_dtype=dtype)
            state = make_train_state(shard_params(layers, mesh))
            before = {axis: {op: list(v) for op, v in ops.items()}
                      for axis, ops in mesh.traffic.items()}
            noisy, clean, starts = shard_train_args(
                mesh, torch.from_numpy(problem["noisy"]),
                torch.from_numpy(problem["clean"]),
                torch.from_numpy(problem["starts"].astype(np.int64)))
            train_chunk(state, noisy, clean, starts, float(problem["lr"]),
                        hyper, mesh=mesh)
            state.model.check_replicas("after the chunk")
            for axis, ops in mesh.traffic.items():
                for op, (calls, sent) in ops.items():
                    out[f"{case}_{axis}_{op}"] = np.array(
                        [calls - before[axis][op][0],
                         sent - before[axis][op][1]])
            if mesh.data_rank == 0:
                whole = gather_params(state.model, mesh)
                vel = gather_layers(state.velocity, mesh)
                for i, (p, v) in enumerate(zip(whole, vel)):
                    for k in ("w", "b"):
                        out[f"{case}_{k}{i}"] = p[k]
                        out[f"{case}_vel_{k}{i}"] = v[k]
            out[f"{case}_alpha"] = state.alpha.numpy()
        if rank == 0:
            np.savez(os.path.join(out_dir, f"tp_{name}.out.npz"), **out)


def run_decode(rank, out_dir):
    from tpu_se_torch.bench.mesh_decode import decode_all

    with np.load(os.path.join(out_dir, "decode.npz")) as z:
        problem = dict(z)
    got = decode_all(os.path.join(out_dir, "m.wts"),
                     os.path.join(out_dir, "m.norm"), problem,
                     make_mesh(device="cpu"), "cpu")
    np.savez(os.path.join(out_dir, f"decode.{rank}.npz"), **got)


def run_axes(rank, out_dir):
    mesh = make_mesh(None, 2, device="cpu")
    mine = torch.full((3,), float(rank))
    data_sum = mesh.all_reduce_sum(mine.clone(), "data")
    model_sum = mesh.all_reduce_sum(mine.clone(), "model")
    data_gather = mesh.all_gather(mine[None], 0, "data")
    model_gather = mesh.all_gather(
        torch.full((2, 1), rank - 30000, dtype=torch.int16), 1, "model")
    # Equal along the data axis (a shard of model index m), different
    # across the model axis: the data check passes, the whole one raises.
    shard = [torch.full((2,), float(mesh.model_rank))]
    mesh.check_replicas(shard, "in the test", axis="data")
    try:
        mesh.check_replicas(shard, "in the test")
        raised = 0
    except RuntimeError:
        raised = 1
    np.savez(os.path.join(out_dir, f"axes.{rank}.npz"),
             data_sum=data_sum.numpy(), model_sum=model_sum.numpy(),
             data_gather=data_gather.numpy(),
             model_gather=model_gather.numpy(), raised=raised,
             traffic=[[n for op in ("all_reduce", "all_gather")
                       for n in mesh.traffic[axis][op]]
                      for axis in ("data", "model")])


def run_replicas(rank):
    mesh = make_mesh(device="cpu")
    weights = [torch.ones(4, 3), torch.zeros(3)]
    if rank == 1:
        weights[0][2, 1] = float(np.nextafter(np.float32(1), np.float32(2)))
    try:
        mesh.check_replicas(weights, "in the test")
    except RuntimeError as e:
        print(e)
        return 5
    return 0


def run_train(argv):
    n_target = int(os.environ.get("TPU_SE_TORCH_CRASH_AFTER_CHUNKS", "0"))
    if n_target:
        import tpu_se_torch.train.loop as loop_mod

        orig = loop_mod.train_chunk
        count = {"n": 0}

        def bomb(*a, **k):
            count["n"] += 1
            if count["n"] > n_target:
                os._exit(7)
            return orig(*a, **k)

        loop_mod.train_chunk = bomb

    from tpu_se_torch.cli.main import main as cli_main

    return cli_main(["train", *argv])


def main() -> int:
    mode = sys.argv[1]
    if mode == "train":
        return run_train(sys.argv[2:])
    rank, n_ranks, port = (int(x) for x in sys.argv[2:5])
    out_dir, rest = sys.argv[5], sys.argv[6:]
    info = initialize_distributed(f"127.0.0.1:{port}", n_ranks, rank, "gloo",
                                  "cpu", timeout=TIMEOUT_S)
    assert info["process_index"] == rank, info
    assert info["process_count"] == info["global_devices"] == n_ranks, info
    assert info["backend"] == "gloo" and info["device"].type == "cpu", info
    try:
        if mode == "allgather":
            run_allgather(rank, n_ranks, out_dir)
        elif mode == "span":
            run_span(rank, n_ranks, out_dir, *rest)
        elif mode == "chunk":
            run_chunk(rank, n_ranks, out_dir, *rest)
        elif mode == "replicas":
            return run_replicas(rank)
        elif mode == "axes":
            run_axes(rank, out_dir)
        elif mode == "tp":
            run_tp(rank, n_ranks, out_dir, *rest)
        elif mode == "decode":
            run_decode(rank, out_dir)
        elif mode == "overlap":
            run_overlap(rank, n_ranks, out_dir)
        else:
            raise SystemExit(f"unknown mode {mode!r}")
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
