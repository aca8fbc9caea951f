"""tpu_se_torch.parallel and the data-parallel step against tpu_se, on the CPU.

The port's twin of ``tests/test_parallel.py``.  Where the reference shards
one process's arrays over the virtual CPU devices, the port runs one
process per rank over gloo (``tests/torch_mp_worker.py``), so the
multi-rank cases start real clusters; each has its own time limit and
kills its ranks when it ends.

- ``shard_for_host``: equal to ``tpu_se``'s over a grid of (n, P);
- ``shard_train_args``: rank k's columns are the block the reference's
  ``NamedSharding(P(None, "data"))`` gives device k;
- ``make_mesh`` / ``MeshConfig`` / ``initialize_distributed`` without a
  coordinator (the card unless the caller asks for the CPU), the mesh's
  rank layout (rank = d * model + m, as the reference's
  ``devices.reshape(data, model)``), and the refusals (more devices than
  ranks, a bunch that the ranks cannot split, bad coordinator arguments);
- the axes' collectives over a 2 x 2 gloo cluster: all-reduce and
  all-gather over ``data`` and over ``model``, int16 carried exactly, the
  replica check over the whole group and over one axis;
- a mesh of one rank without a group is the one-device step bit for bit
  (``output_grad_and_alpha`` and ``train_chunk``);
- the dropout masks of P ranks are one process's, row for row;
- ``train_chunk`` over P in {2, 4} gloo ranks, ``ml`` in {True, False},
  on ``tests/test_parallel.py``'s problem: against one process of the port
  and against ``tpu_se``'s ``train_chunk`` under ``make_mesh(P, 1)`` on
  the virtual CPU devices, weights rtol 2e-4, atol 1e-6, alpha rtol 1e-4
  (``tests/test_parallel.py:59-63``: P partial sums added are not one sum
  over M rows);
- the ``train`` parser takes the mesh flags; a hidden width that the
  model axis cannot split stops every front end before a rank starts
  (the model axis itself: ``tests/test_torch_tensor_parallel.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_se.parallel as ref_parallel
import tpu_se.train as ref_train
from torch_mp_worker import run_ranks
from tpu_se.data.pipeline import shard_for_host as ref_shard_for_host
from tpu_se.models import init_params as jax_init_params
from tpu_se_torch import parallel, train
from tpu_se_torch.cli.main import build_parser
from tpu_se_torch.cli.main import main as cli_main
from tpu_se_torch.data import shard_for_host
from tpu_se_torch.losses import output_grad_and_alpha
from tpu_se_torch.models import params_from_numpy
from tpu_se_torch.ops import ggd_kernel
from tpu_se_torch.parallel import distributed, mesh as mesh_mod
from tpu_se_torch.parallel.mesh import Mesh, free_port

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mp_worker.py")


@pytest.mark.parametrize("count", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [0, 1, 7, 10, 128, 1001])
def test_shard_for_host_matches_tpu_se(n, count):
    got = [shard_for_host(n, k, count) for k in range(count)]
    assert got == [ref_shard_for_host(n, k, count) for k in range(count)]
    assert got[0].start == 0 and got[-1].stop == n
    assert all(a.stop == b.start for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_shard_train_args_takes_the_reference_block(size):
    devices = jax.devices()
    if len(devices) < size:
        pytest.skip(f"need {size} virtual devices")
    starts = np.arange(3 * 16, dtype=np.int32).reshape(3, 16)
    noisy = np.zeros((4, 2), np.float32)
    placed = ref_parallel.shard_train_args(
        ref_parallel.make_mesh(size, 1), noisy, noisy, starts)[2]
    blocks = {s.device.id: np.asarray(s.data)
              for s in placed.addressable_shards}
    for rank in range(size):
        n, c, got = parallel.shard_train_args(
            Mesh(rank, size, "cpu", None), noisy, noisy,
            torch.from_numpy(starts))
        assert n is noisy and c is noisy
        np.testing.assert_array_equal(got.numpy(),
                                      blocks[devices[rank].id])


def test_shard_train_args_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="16 samples does not split evenly "
                                         "over 3 ranks"):
        parallel.shard_train_args(Mesh(0, 3, "cpu", None), None, None,
                                  torch.zeros(2, 16))


def test_mesh_config_and_one_rank_mesh():
    cfg = parallel.MeshConfig(4)
    assert (cfg.data, cfg.model, cfg.n_devices) == (4, 1, 4)
    assert parallel.MeshConfig(2, 3).n_devices == 6
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)
    assert (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank) == (
        1, 1, 0, 0)
    assert mesh.device == torch.device("cpu")
    t = torch.arange(3, dtype=torch.float32)
    assert mesh.all_reduce_sum(t) is t and mesh.all_reduce_calls == 0
    assert mesh.all_gather(t, 0, "model") is t
    mesh.check_replicas([t], "alone")          # nothing to compare with
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            parallel.make_mesh()               # the card, unless told cpu


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_mesh_lays_ranks_out_as_the_reference_reshape(data, model):
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("need 8 virtual devices")
    ref = np.vectorize(lambda d: d.id)(
        ref_parallel.make_mesh(data, model).devices)
    for rank in range(8):
        mesh = Mesh(rank, 8, "cpu", None, model=model)
        d, m = mesh.data_rank, mesh.model_rank
        assert (mesh.data, mesh.model) == (data, model)
        assert ref[d, m] == devices[rank].id
        assert mesh.axis_ranks("data") == [devices.index(dev) for dev in
                                           ref_parallel.make_mesh(
                                               data, model).devices[:, m]]
        assert mesh.axis_ranks("model") == [
            d * model + k for k in range(model)]


def test_make_mesh_refusals():
    # The reference's own words when devices are short (mesh.py:44-46).
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        parallel.make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError) as ref_err:
        ref_parallel.make_mesh(16, 1)
    assert "mesh 16x1 needs 16 devices, have" in str(ref_err.value)
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        parallel.make_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match="model axis of 3 does not divide"):
        Mesh(0, 4, "cpu", "gloo", model=3)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        Mesh(0, 2, "cpu", "gloo").all_reduce_sum(torch.zeros(2), "rows")
    with pytest.raises(ValueError, match="takes float32"):
        Mesh(0, 2, "cpu", "gloo").all_reduce_sum(torch.zeros(2).double())


def test_initialize_distributed_without_a_coordinator_is_a_noop():
    info = parallel.initialize_distributed(device="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1,
                    "device": torch.device("cpu"), "backend": None}
    assert not torch.distributed.is_initialized()
    parallel.sync_processes("alone")
    parallel.shutdown_distributed()


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(coordinator_address="127.0.0.1:1"), ValueError,
     "needs num_processes and process_id"),
    (dict(coordinator_address="127.0.0.1:1", num_processes=2, process_id=2),
     ValueError, "process_id 2 is not in"),
    (dict(coordinator_address="nowhere", num_processes=1, process_id=0),
     ValueError, "is not host:port"),
    (dict(coordinator_address="127.0.0.1:1", num_processes=1, process_id=0,
          cpu_collectives="mpi"), ValueError, "only host implementation"),
], ids=["no-counts", "rank-out-of-range", "no-port", "not-gloo"])
def test_initialize_distributed_rejects(kwargs, error, match):
    with pytest.raises(error, match=match):
        parallel.initialize_distributed(**kwargs)
    assert not torch.distributed.is_initialized()


def test_collective_backend_and_rank_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert distributed.collective_backend(cpu, None) == "gloo"
    assert distributed.collective_backend(cuda, None) == "nccl"
    assert distributed.collective_backend(cuda, "gloo") == "gloo"
    assert distributed.rank_device("cpu", 3) == cpu
    assert distributed.rank_device("cuda:1", 0) == torch.device("cuda", 1)
    mesh_mod.check_mesh_devices(2, 1, 2)
    with pytest.raises(ValueError, match="mesh 4x1 needs 4 devices, have 1"):
        mesh_mod.check_mesh_devices(4, 1, 1)


def _problem(seed=0, dim=8, ctx=3, m=16, n_bunches=4, n_frames=128):
    """``tests/test_parallel.py``'s problem, as numpy."""
    rng = np.random.default_rng(seed)
    noisy = rng.normal(size=(n_frames, dim)).astype(np.float32)
    clean = rng.normal(size=(n_frames, dim)).astype(np.float32)
    starts = rng.integers(0, n_frames - ctx,
                          size=(n_bunches, m)).astype(np.int32)
    layers = [{"w": np.asarray(l["w"]).copy(), "b": np.asarray(l["b"]).copy()}
              for l in jax_init_params(seed + 1, (dim * ctx, 16, 16, dim))]
    return noisy, clean, starts, layers


HYPER = dict(beta=1.0, bunchsize=16, context=3, targ_offset=1)
LR = 0.05


def _port_chunk(noisy, clean, starts, layers, ml, mesh=None, **hyper):
    state = train.make_train_state(params_from_numpy(layers, "cpu"))
    starts = torch.from_numpy(starts.astype(np.int64))
    if mesh is not None:
        _, _, starts = parallel.shard_train_args(mesh, None, None, starts)
    return train.train_chunk(state, torch.from_numpy(noisy),
                             torch.from_numpy(clean), starts, LR,
                             train.TrainHyper(ml=ml, **{**HYPER, **hyper}),
                             mesh=mesh)


@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("ml", [True, False])
def test_one_rank_mesh_is_the_one_device_step_bitwise(ml, beta):
    out = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 9)).astype(np.float32))
    targ = out.roll(1, 0) * 0.5
    mesh = Mesh(0, 1, "cpu", None)
    for got, want in zip(output_grad_and_alpha(out, targ, beta, ml, mesh),
                         output_grad_and_alpha(out, targ, beta, ml)):
        assert torch.equal(got, want)

    problem = _problem()
    single = _port_chunk(*problem, ml, beta=beta)
    meshed = _port_chunk(*problem, ml, mesh=mesh, beta=beta)
    for a, b in zip(single.model.parameters(), meshed.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(single.alpha, meshed.alpha)
    assert ggd_kernel.colsum_launches == 0 == ggd_kernel.launches


def test_one_rank_mesh_in_bf16_is_the_one_device_step_bitwise():
    # Each rank rounds its partial dW to bfloat16 before the float32 sum;
    # with one rank there is nothing to add, so the bits are one device's.
    problem = _problem()
    single = _port_chunk(*problem, True, compute_dtype="bfloat16")
    meshed = _port_chunk(*problem, True, mesh=Mesh(0, 1, "cpu", None),
                         compute_dtype="bfloat16")
    for a, b in zip(single.model.parameters(), meshed.model.parameters()):
        assert torch.equal(a, b)
    fp32 = _port_chunk(*problem, True)
    assert not torch.equal(single.model.weights[0], fp32.model.weights[0])


def test_train_chunk_refuses_starts_of_another_split():
    noisy, clean, starts, layers = _problem()
    state = train.make_train_state(params_from_numpy(layers, "cpu"))
    with pytest.raises(ValueError, match="got 16 columns of starts for a "
                                         "bunch of 16"):
        train.train_chunk(state, torch.from_numpy(noisy),
                          torch.from_numpy(clean),
                          torch.from_numpy(starts.astype(np.int64)), LR,
                          train.TrainHyper(ml=True, **HYPER),
                          mesh=Mesh(0, 2, "cpu", None))


@pytest.mark.parametrize("size", [2, 4])
def test_dropout_masks_of_the_ranks_are_one_process_masks(size):
    """Every rank draws the whole bunch's masks from the same seed and
    keeps its rows: together the ranks compute what one process does."""
    _, _, _, layers = _problem()
    model = params_from_numpy(layers, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16, 24)).astype(np.float32))

    def gen():
        return torch.Generator().manual_seed(77)

    with torch.no_grad():
        whole = model(x, dropout=(0.2, 0.5), generator=gen())
        per = 16 // size
        parts = [model(x[k * per:(k + 1) * per], dropout=(0.2, 0.5),
                       generator=gen(), dropout_rows=(k * per, 16))
                 for k in range(size)]
    got = torch.cat(parts)
    # A row's product does not depend on its neighbours' rows, but the CPU
    # GEMM may block another way at another height: float32 ulps.
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)
    assert not torch.equal(whole, model(x))          # masks were drawn


def _jax_chunk(noisy, clean, starts, layers, ml, size):
    mesh = ref_parallel.make_mesh(size, 1)
    params = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    args = ref_parallel.shard_train_args(mesh, noisy, clean, starts)
    return ref_train.train_chunk(
        ref_train.make_train_state(params, layers[-1]["b"].shape[0]),
        *(jnp.asarray(a) for a in args), jnp.float32(LR),
        ref_train.TrainHyper(ml=ml, **HYPER))


@pytest.mark.parametrize("ml", [True, False])
@pytest.mark.parametrize("size", [2, 4])
def test_train_chunk_over_gloo_ranks_matches_one_process_and_jax(
        size, ml, tmp_path):
    if len(jax.devices()) < size:
        pytest.skip(f"need {size} virtual devices")
    noisy, clean, starts, layers = _problem()
    arrays = {"noisy": noisy, "clean": clean, "starts": starts, "lr": LR,
              "context": HYPER["context"],
              "targ_offset": HYPER["targ_offset"]}
    for i, layer in enumerate(layers):
        arrays[f"w{i}"], arrays[f"b{i}"] = layer["w"], layer["b"]
    np.savez(tmp_path / "problem.npz", **arrays)
    port = free_port()
    codes, logs = run_ranks(
        lambda k: [WORKER, "chunk", str(k), str(size), str(port),
                   str(tmp_path), str(int(ml)), "1.0"], size, timeout=120)
    assert codes == [0] * size, "\n".join(logs)
    got = np.load(tmp_path / "chunk.npz")
    # Two collectives per ML bunch (column sums, gradients), one otherwise.
    assert got["all_reduce_calls"] == len(starts) * (2 if ml else 1)

    single = _port_chunk(noisy, clean, starts, layers, ml)
    want = _jax_chunk(noisy, clean, starts, layers, ml, size)
    for i, (p, jl) in enumerate(zip(train.param_layers(single.model),
                                    want.params)):
        for k in ("w", "b"):
            for ref in (p[k].detach().numpy(), np.asarray(jl[k])):
                np.testing.assert_allclose(got[f"{k}{i}"], ref, rtol=2e-4,
                                           atol=1e-6)
    for ref in (single.alpha.numpy(), np.asarray(want.alpha)):
        np.testing.assert_allclose(got["alpha"], ref, rtol=1e-4)


def test_train_parser_takes_the_mesh_flags():
    args = build_parser().parse_args([
        "train", "--fea-file", "a", "--targ-file", "b", "--norm-file", "c",
        "--mesh-data", "2", "--mesh-model", "1", "--coordinator",
        "127.0.0.1:9", "--num-processes", "2", "--process-id", "1",
        "--cpu-collectives", "gloo"])
    assert (args.mesh_data, args.mesh_model, args.coordinator,
            args.num_processes, args.process_id, args.cpu_collectives) == (
                2, 1, "127.0.0.1:9", 2, 1, "gloo")
    assert args.device == "cuda"                    # unless told cpu
    defaults = build_parser().parse_args([
        "train", "--fea-file", "a", "--targ-file", "b", "--norm-file", "c"])
    assert (defaults.mesh_data, defaults.mesh_model, defaults.coordinator,
            defaults.num_processes, defaults.process_id,
            defaults.cpu_collectives) == (1, 1, "", None, None, "")


@pytest.mark.parametrize("front_end", ["train", "bptrain", "run_training"])
def test_mesh_model_is_refused_as_queued(front_end, tmp_path):
    """The model axis runs (``tests/test_torch_tensor_parallel.py``); what
    every front end still refuses, before a rank starts, is a hidden width
    that the model axis cannot split."""
    out = tmp_path / "out"
    match = "hidden width 63 does not split evenly over 2 ranks"
    if front_end == "train":
        with pytest.raises(ValueError, match=match):
            cli_main(["train", "--fea-file", "a", "--targ-file", "b",
                      "--norm-file", "c", "--out-dir", str(out),
                      "--layersizes", "1799,63,257", "--mesh-model", "2",
                      "--device", "cpu"])
    elif front_end == "bptrain":
        with pytest.raises(SystemExit, match=f"{match}.*mesh_model=2"):
            cli_main(["bptrain", "fea_file=a", "targ_file=b", "norm_file=c",
                      f"outwts_file={out}/m.wts", "layersizes=1799,63,257",
                      "mesh_model=2", "device=cpu"])
    else:
        with pytest.raises(ValueError, match=match):
            train.run_training(train.TrainConfig(
                out_dir=str(out), layersizes=(1799, 63, 257),
                mesh=parallel.MeshConfig(1, 2)), "cpu")
    assert not out.exists()


def test_mesh_axes_collectives_over_gloo_ranks(tmp_path):
    """A 2 x 2 mesh: every rank's sums, gathers and replica checks along
    each axis are those of its line of the reference's grid."""
    port = free_port()
    codes, logs = run_ranks(
        lambda k: [WORKER, "axes", str(k), "4", str(port), str(tmp_path)],
        4, timeout=120)
    assert codes == [0] * 4, "\n".join(logs)
    for rank in range(4):
        d, m = divmod(rank, 2)
        got = np.load(tmp_path / f"axes.{rank}.npz")
        data_line, model_line = [m, 2 + m], [2 * d, 2 * d + 1]
        np.testing.assert_array_equal(got["data_sum"],
                                      np.full(3, sum(data_line), np.float32))
        np.testing.assert_array_equal(got["model_sum"],
                                      np.full(3, sum(model_line), np.float32))
        np.testing.assert_array_equal(
            got["data_gather"], np.array(data_line, np.float32)[:, None]
            * np.ones((1, 3), np.float32))
        np.testing.assert_array_equal(
            got["model_gather"], np.concatenate(
                [np.full((2, 1), r, np.int16) - 30000 for r in model_line],
                axis=1))
        assert got["model_gather"].dtype == np.int16
        # 2 all-reduces (one per axis), and per axis one gather: the bytes
        # are what this rank gave.
        np.testing.assert_array_equal(got["traffic"],
                                      [[1, 12, 1, 12], [1, 12, 1, 8]])
        assert got["raised"] == 1


def test_mesh_data_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        cli_main(["train", "--fea-file", "a", "--targ-file", "b",
                  "--norm-file", "c", "--out-dir", str(tmp_path / "out"),
                  "--mesh-data", "2"])
    assert not (tmp_path / "out").exists()
