"""The model axis of tpu_se_torch (tensor-parallel hidden layers) against
tpu_se, on the CPU.

The port's twin of ``tests/test_parallel.py:66-113``.  Where the reference
places one process's parameters with ``param_shardings`` on the virtual
CPU devices, the port runs one process per rank over gloo
(``tests/torch_mp_worker.py tp``); each cluster has its own time limit and
kills its ranks when it ends.

- ``param_shardings``: the reference's layout for 2 to 5 layers;
- ``shard_params``: each rank's blocks, which joined over the model axis
  give back the layers; a hidden width that does not split raises, also
  before a run starts its ranks (``check_model_split``);
- the dropout mask of a rank's rows and columns is that block of one
  process's mask;
- clusters of (dp, tp) in {(1, 2), (2, 2), (1, 4)} on two networks:
  ``tests/test_parallel.py``'s problem at (24, 16, 16, 8) (a row-parallel
  output feeds the output layer) and (1799, 64, 64, 64, 257) (a
  column-parallel output is all-gathered before it, as at full width):
  - the forward pass, with and without dropout, against the port's one
    process and ``tpu_se``'s forward under ``param_shardings``: rtol 2e-4,
    atol 1e-5 (``tests/test_parallel.py:79``);
  - ``train_chunk`` for ``ml`` in {True, False}: weights and biases rtol
    2e-4, atol 1e-6, alpha rtol 1e-4, against the port's one process and
    ``tpu_se``'s ``train_chunk`` under ``make_mesh(dp, tp)`` with
    ``param_shardings`` (``tests/test_parallel.py:107-113``: the model
    axis reassociates the hidden products); the collectives counted per
    axis and bunch;
  - ``train_chunk`` in bfloat16 against the port's one process in
    bfloat16, within 2^-7 of each tensor's change (the partial products
    are rounded to bfloat16 per rank before their sum, ROADMAP "Parity
    rules");
- the CLI: ``train --mesh-data 1 --mesh-model 2 --device cpu`` at (1799,
  64, 257) within the same tolerances of one process, a rerun through
  ``--coordinator`` byte-identical, ``bptrain mesh_model=2`` the same
  epoch's bytes, and a tp=2 run killed mid-epoch and resumed byte-exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_se.parallel as ref_parallel
import tpu_se.train as ref_train
from test_torch_distributed import SIZES, pair, train_argv, two_ranks  # noqa: F401
from torch_mp_worker import run_ranks
from tpu_se.io import read_wts as ref_read_wts
from tpu_se.models import forward as jax_forward
from tpu_se.models import init_params as jax_init_params
from tpu_se_torch import parallel, train
from tpu_se_torch.cli.main import main as cli_main
from tpu_se_torch.io import read_wts
from tpu_se_torch.models import params_from_numpy
from tpu_se_torch.models.ffn import input_dropout
from tpu_se_torch.parallel.mesh import Mesh, free_port
from tpu_se_torch.parallel.tensor import check_model_split, shard_layers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mp_worker.py")
MESHES = [(1, 2), (2, 2), (1, 4)]
NETS = {"small": dict(dim=8, ctx=3, sizes=(24, 16, 16, 8), targ_offset=1),
        "wide": dict(dim=257, ctx=7, sizes=(1799, 64, 64, 64, 257),
                     targ_offset=3)}
LR = 0.05
BF16_SHARE = 2.0 ** -7


def _problem(net, seed=0, m=16, n_bunches=4, n_frames=128):
    """``tests/test_parallel.py``'s problem (its ``_problem`` at the small
    network), as numpy, plus a batch ``x`` for the forward pass."""
    spec = NETS[net]
    rng = np.random.default_rng(seed)
    noisy = rng.normal(size=(n_frames, spec["dim"])).astype(np.float32)
    clean = rng.normal(size=(n_frames, spec["dim"])).astype(np.float32)
    starts = rng.integers(0, n_frames - spec["ctx"],
                          size=(n_bunches, m)).astype(np.int32)
    layers = [{k: np.asarray(v).copy() for k, v in layer.items()}
              for layer in jax_init_params(seed + 1, spec["sizes"])]
    x = np.random.default_rng(1).normal(
        size=(8, spec["sizes"][0])).astype(np.float32)
    return {"noisy": noisy, "clean": clean, "starts": starts, "x": x,
            "layers": layers, "context": spec["ctx"],
            "targ_offset": spec["targ_offset"]}


def _hyper(p, ml, **kw):
    return dict(beta=1.0, ml=ml, bunchsize=p["starts"].shape[1],
                context=p["context"], targ_offset=p["targ_offset"], **kw)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """One gloo cluster per mesh shape, each running every network ->
    {(dp, tp): {net: the rank-0 outputs}}."""
    out = {}
    for dp, tp in MESHES:
        where = tmp_path_factory.mktemp(f"tp_{dp}x{tp}")
        for net in NETS:
            p = _problem(net)
            arrays = {k: p[k] for k in ("noisy", "clean", "starts", "x",
                                        "context", "targ_offset")}
            arrays.update(lr=LR, bf16=1)
            for i, layer in enumerate(p["layers"]):
                arrays[f"w{i}"], arrays[f"b{i}"] = layer["w"], layer["b"]
            np.savez(where / f"tp_{net}.npz", **arrays)
        port = free_port()
        n = dp * tp
        codes, logs = run_ranks(
            lambda k: [WORKER, "tp", str(k), str(n), str(port), str(where),
                       str(tp), *NETS], n, timeout=180)
        assert codes == [0] * n, "\n".join(logs)
        out[(dp, tp)] = {net: dict(np.load(where / f"tp_{net}.out.npz"))
                         for net in NETS}
    return out


def _port_chunk(p, ml, **kw):
    state = train.make_train_state(params_from_numpy(p["layers"], "cpu"))
    return train.train_chunk(
        state, torch.from_numpy(p["noisy"]), torch.from_numpy(p["clean"]),
        torch.from_numpy(p["starts"].astype(np.int64)), LR,
        train.TrainHyper(**_hyper(p, ml, **kw)))


def _jax_chunk(p, ml, dp, tp):
    """``tests/test_parallel.py:92-106``: the reference's step on a dp x tp
    mesh of the virtual CPU devices with ``param_shardings``."""
    mesh = ref_parallel.make_mesh(dp, tp)
    specs = ref_parallel.param_shardings(mesh, len(p["layers"]))
    params = [{k: jax.device_put(jnp.asarray(layer[k]), s[k])
               for k in ("w", "b")} for layer, s in zip(p["layers"], specs)]
    state = ref_train.make_train_state(params, p["layers"][-1]["b"].shape[0])
    state.alpha = jax.device_put(state.alpha,
                                 ref_parallel.replicated_sharding(mesh))
    args = ref_parallel.shard_train_args(mesh, p["noisy"], p["clean"],
                                         p["starts"])
    return ref_train.train_chunk(state, *(jnp.asarray(a) for a in args),
                                 jnp.float32(LR),
                                 ref_train.TrainHyper(**_hyper(p, ml)))


def _need(dp, tp):
    if len(jax.devices()) < dp * tp:
        pytest.skip(f"need {dp * tp} virtual devices")


@pytest.mark.parametrize("n_layers", [2, 3, 4, 5])
@pytest.mark.parametrize("model", [1, 2, 4])
def test_param_shardings_match_tpu_se(n_layers, model):
    _need(8 // model, model)
    ref = ref_parallel.param_shardings(
        ref_parallel.make_mesh(8 // model, model), n_layers)
    got = parallel.param_shardings(Mesh(0, 8, "cpu", None, model=model),
                                   n_layers)
    assert got == [{k: tuple(s[k].spec) for k in ("w", "b")} for s in ref]


@pytest.mark.parametrize("model", [2, 4])
def test_shard_params_blocks_join_back_to_the_layers(model):
    layers = _problem("wide")["layers"]
    blocks = [shard_layers(layers, Mesh(m, model, "cpu", None, model=model))
              for m in range(model)]
    specs = parallel.param_shardings(Mesh(0, model, "cpu", None,
                                          model=model), len(layers))
    for i, (layer, spec) in enumerate(zip(layers, specs)):
        for k in ("w", "b"):
            parts = [b[i][k] for b in blocks]
            if "model" in spec[k]:
                axis = spec[k].index("model")
                assert parts[0].shape[axis] * model == layer[k].shape[axis]
                joined = np.concatenate(parts, axis=axis)
            else:
                assert all(part is not None for part in parts)
                joined = parts[1]
            np.testing.assert_array_equal(joined, layer[k])
    mesh = Mesh(1, model, "cpu", None, model=model)
    model_ = parallel.shard_params(layers, mesh)
    assert [tuple(w.shape) for w in model_.weights] == [
        (1799, 64 // model), (64 // model, 64), (64, 64 // model), (64, 257)]
    np.testing.assert_array_equal(model_.biases[0].detach().numpy(),
                                  layers[0]["b"][64 // model:
                                                 2 * 64 // model])


@pytest.mark.parametrize("sizes,model,width", [
    ((1799, 63, 257), 2, 63), ((1799, 64, 64, 64, 257), 3, 64),
    ((24, 16, 16, 10, 8), 4, 10)])
def test_a_width_that_does_not_split_raises(sizes, model, width):
    match = f"hidden width {width} does not split evenly over {model} ranks"
    with pytest.raises(ValueError, match=match):
        check_model_split(sizes, model)
    with pytest.raises(ValueError, match=match):
        parallel.shard_params(jax_init_params(0, sizes),
                              Mesh(0, model, "cpu", None, model=model))
    check_model_split(sizes, 1)                   # nothing splits


@pytest.mark.parametrize("data,model", MESHES)
def test_dropout_block_is_one_process_mask_block(data, model):
    """A rank draws the whole bunch's mask at full width from the shared
    seed and keeps its rows and, for a split input, its columns."""
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (16, 32)).astype(np.float32))
    whole = input_dropout(h, 0.3, torch.Generator().manual_seed(5))
    rows, cols = 16 // data, 32 // model
    for d in range(data):
        for m in range(model):
            block = h[d * rows:(d + 1) * rows, m * cols:(m + 1) * cols]
            got = input_dropout(block, 0.3, torch.Generator().manual_seed(5),
                                (d * rows, 16), (m, model))
            assert torch.equal(got, whole[d * rows:(d + 1) * rows,
                                          m * cols:(m + 1) * cols])
    assert (whole == 0).any() and (whole != 0).any()


@pytest.mark.parametrize("net", list(NETS))
@pytest.mark.parametrize("dp,tp", MESHES)
def test_forward_matches_one_process_and_jax(clusters, dp, tp, net):
    _need(dp, tp)
    p = _problem(net)
    got = clusters[(dp, tp)][net]
    x = torch.from_numpy(p["x"])
    single = params_from_numpy(p["layers"], "cpu")
    with torch.no_grad():
        one = single(x).numpy()
        dropped = single(x, dropout=(0.2, 0.5),
                         generator=torch.Generator().manual_seed(77)).numpy()
    mesh = ref_parallel.make_mesh(dp, tp)
    specs = ref_parallel.param_shardings(mesh, len(p["layers"]))
    params = [{k: jax.device_put(jnp.asarray(layer[k]), s[k])
               for k in ("w", "b")} for layer, s in zip(p["layers"], specs)]
    ref = np.asarray(jax.jit(jax_forward)(params, jnp.asarray(p["x"])))
    for want in (one, ref):
        np.testing.assert_allclose(got["forward"], want, rtol=2e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(got["dropout"], dropped, rtol=2e-4, atol=1e-5)
    assert not np.allclose(got["dropout"], one)          # masks were drawn


@pytest.mark.parametrize("ml", [True, False])
@pytest.mark.parametrize("net", list(NETS))
@pytest.mark.parametrize("dp,tp", MESHES)
def test_train_chunk_matches_one_process_and_jax(clusters, dp, tp, net, ml):
    _need(dp, tp)
    p = _problem(net)
    got = clusters[(dp, tp)][net]
    case = "ml1" if ml else "ml0"
    single = _port_chunk(p, ml)
    want = _jax_chunk(p, ml, dp, tp)
    for i, (layer, jl) in enumerate(zip(train.param_layers(single.model),
                                        want.params)):
        for k in ("w", "b"):
            for ref in (layer[k].detach().numpy(), np.asarray(jl[k])):
                np.testing.assert_allclose(got[f"{case}_{k}{i}"], ref,
                                           rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(got[f"{case}_vel_w{i}"],
                                   single.velocity[i]["w"].numpy(),
                                   rtol=2e-4, atol=1e-6)
    for ref in (single.alpha.numpy(), np.asarray(want.alpha)):
        np.testing.assert_allclose(got[f"{case}_alpha"], ref, rtol=1e-4)
    # Per bunch: the data axis sums the GGD column sums (ML) and the
    # gradients; the model axis sums each row-parallel layer's partial z
    # forward and each column-parallel layer's input gradient backward
    # (not the first layer's: x needs none), and the wide network gathers
    # layer 2's columns before its output layer.
    bunches = len(p["starts"])
    n_row = (len(p["layers"]) - 1) // 2
    n_col_grad = (len(p["layers"]) - 1 + 1) // 2 - 1
    data_calls = (2 if ml else 1) * bunches if dp > 1 else 0
    assert got[f"{case}_data_all_reduce"][0] == data_calls
    assert got[f"{case}_model_all_reduce"][0] == (n_row + n_col_grad) * bunches
    assert got[f"{case}_model_all_gather"][0] == (
        bunches if net == "wide" else 0)
    assert got[f"{case}_data_all_gather"][0] == 0


@pytest.mark.parametrize("dp,tp", MESHES)
def test_train_chunk_in_bf16_matches_one_process(clusters, dp, tp):
    p = _problem("small")
    got = clusters[(dp, tp)]["small"]
    single = _port_chunk(p, True, compute_dtype="bfloat16")
    for i, layer in enumerate(train.param_layers(single.model)):
        for k in ("w", "b"):
            one = layer[k].detach().numpy()
            change = np.abs(one - p["layers"][i][k]).max()
            assert change > 0
            assert (np.abs(got[f"bf16_{k}{i}"] - one).max()
                    <= BF16_SHARE * change), (i, k)


def _one_process(pair, out, **kw):
    cfg = train.TrainConfig(
        fea_file=pair["fea"], targ_file=pair["targ"], norm_file=pair["norm"],
        init_wts_file=pair["init"], out_dir=str(out),
        layersizes=(1799, 64, 257), epochs=2, init_seed=11, traincache=512,
        train_sent_range=(0, 7), cv_sent_range=(8, 9), **kw)
    train.run_training(cfg, "cpu", log=lambda s: None)
    return out


@pytest.fixture(scope="module")
def tp_run(pair, tmp_path_factory):
    """``train --mesh-data 1 --mesh-model 2 --device cpu``: two local
    ranks started by the command."""
    out = tmp_path_factory.mktemp("tp_run") / "out"
    codes, logs = run_ranks(
        lambda k: ["-m", "tpu_se_torch", "train",
                   *train_argv(pair, out, extra=["--mesh-data", "1",
                                                 "--mesh-model", "2"])],
        1, timeout=240)
    assert codes == [0], logs[0]
    return out, logs[0]


def test_tensor_parallel_training_matches_one_process(pair, tp_run, tmp_path):
    out, log = tp_run
    assert "data mesh: starting 2 local ranks on cpu" in log
    assert "data mesh: data=1, model=2, rank 0 on cpu (gloo)" in log
    assert "replicas equal at 2 epoch ends" in log
    assert log.count("epoch 2: sq=") == 1           # rank 1 stays quiet
    one = _one_process(pair, tmp_path / "one")
    for e in (1, 2):
        for g, w in zip(read_wts(out / f"mlp.{e}.wts"),
                        read_wts(one / f"mlp.{e}.wts")):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=1e-6)
    assert sorted(os.listdir(out)) == [
        "metrics.jsonl", "mlp.1.log", "mlp.1.wts", "mlp.2.log", "mlp.2.wts"]


def test_tensor_parallel_training_matches_tpu_se_mesh(pair, tp_run, tmp_path):
    """``tpu_se``'s CLI model axis only replicates (ROADMAP §C); its
    ``param_shardings`` layout through ``run_training`` is the library's.
    Both give the one-device numbers within the same tolerance."""
    out, _ = tp_run
    cfg = ref_train.TrainConfig(
        fea_file=pair["fea"], targ_file=pair["targ"], norm_file=pair["norm"],
        init_wts_file=pair["init"], out_dir=str(tmp_path / "jax"),
        layersizes=(1799, 64, 257), epochs=2, init_seed=11, traincache=512,
        train_sent_range=(0, 7), cv_sent_range=(8, 9),
        mesh=ref_parallel.make_mesh(1, 2, devices=jax.devices()[:2]))
    final = ref_train.run_training(cfg, log=lambda s: None)
    for g, w in zip(read_wts(out / "mlp.2.wts"), ref_read_wts(final)):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=1e-6)


def test_tensor_parallel_rerun_over_a_coordinator_is_byte_identical(
        pair, tp_run, tmp_path):
    out, _ = tp_run
    codes, logs = two_ranks(train_argv(pair, tmp_path / "again",
                                       extra=["--mesh-model", "2"]))
    assert codes == [0, 0], "\n".join(logs)
    for rank, log in enumerate(logs):
        assert f"data mesh: data=1, model=2, rank {rank} on cpu" in log
        assert "model axis all_reduce" in log
    for e in (1, 2):
        assert ((tmp_path / "again" / f"mlp.{e}.wts").read_bytes()
                == (out / f"mlp.{e}.wts").read_bytes())


def test_bptrain_mesh_model_writes_the_tensor_parallel_epoch(pair, tp_run,
                                                            tmp_path):
    out, _ = tp_run
    argv = ["-m", "tpu_se_torch", "bptrain", f"layersizes={SIZES}",
            "bunchsize=128", "MLflag=1", "shapefactor=1", "lrate=0.1",
            "traincache=512", "init_randem_seed=11",
            f"initwts_file={pair['init']}", f"norm_file={pair['norm']}",
            f"fea_file={pair['fea']}", f"targ_file={pair['targ']}",
            f"outwts_file={tmp_path}/mlp.1.wts",
            f"log_file={tmp_path}/mlp.1.log", "train_sent_range=0-7",
            "cv_sent_range=8-9", "mesh_model=2", "device=cpu"]
    codes, logs = run_ranks(lambda k: argv, 1, timeout=240)
    assert codes == [0], logs[0]
    assert sorted(os.listdir(tmp_path)) == ["mlp.1.log", "mlp.1.wts"]
    assert ((tmp_path / "mlp.1.wts").read_bytes()
            == (out / "mlp.1.wts").read_bytes())
    assert "mesh_model: 2" in (tmp_path / "mlp.1.log").read_text()


def test_tensor_parallel_midepoch_kill_resume_is_byte_exact(pair, tmp_path):
    """Both ranks of a tp=2 run ``os._exit(7)`` on their 4th chunk
    dispatch (rank 0 committed the partial checkpoint of chunk 3, whole
    tensors gathered over the model axis); the restarted ranks read it,
    take their shards and end on the uninterrupted run's bytes."""
    def argv(out):
        return train_argv(pair, out, epochs=1, extra=[
            "--layersizes", "1799,32,257", "--init-wts", "",
            "--traincache", "256", "--bunchsize", "32",
            "--checkpoint-every-chunks", "1", "--mesh-model", "2",
            "--carry-velocity"])

    codes, logs = two_ranks(argv(tmp_path / "a"), module=False)
    assert codes == [0, 0], "\n".join(logs)
    want = (tmp_path / "a" / "mlp.1.wts").read_bytes()

    codes, logs = two_ranks(
        argv(tmp_path / "b"), module=False, expect_failure=True,
        env={"TPU_SE_TORCH_CRASH_AFTER_CHUNKS": "3"})
    assert codes == [7, 7], (codes, "\n".join(logs))
    assert (tmp_path / "b" / "mlp.1.partial.3.wts").exists()
    assert (tmp_path / "b" / "mlp.1.partial.3.wts.state.npz").exists()
    assert not (tmp_path / "b" / "mlp.1.wts").exists()

    codes, logs = two_ranks(argv(tmp_path / "b"), module=False)
    assert codes == [0, 0], "\n".join(logs)
    for log in logs:
        assert "resuming mid-epoch at chunk 3" in log, log
    assert (tmp_path / "b" / "mlp.1.wts").read_bytes() == want
    sidecar = [np.load(tmp_path / d / "mlp.1.wts.state.npz") for d in "ab"]
    assert all(np.array_equal(sidecar[0][k], sidecar[1][k])
               for k in sidecar[0].files)
    assert sidecar[0]["vel_w_0"].shape == (1799, 32)     # whole tensors
