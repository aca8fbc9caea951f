"""The mesh paths across cards: NCCL, one rank per card, against one
process on the card.

Every test here is marked ``cuda`` and skips on a machine with fewer cards
than its mesh has ranks (2 or 4), so a CPU run skips them all.  The
ranks are child processes of ``python -m tpu_se_torch train`` and of
``python -m tpu_se_torch.bench.mesh_decode``, started by
``tests/torch_mp_worker.py:run_ranks`` (a time limit per cluster; no child
outlives it), rank k on card k.  Fixtures and checks are
``chip_smoke.py``'s: the full-width model (1799, 2048 x 3, 257) from
``gen-rand-net``, its synthetic training pfiles and its four utterances.

- ``train --mesh-model 2`` at data 1 and 2 (1 x 2 on two cards, 2 x 2 on
  four), float32 at lrate 0.001, each run twice: each rank's closing
  ``data mesh:`` line holds the layout's collectives (``tp_want``) and
  replicas equal at both epoch ends; weight changes within 1e-3 and CV
  metrics within 1e-4 of the one-process card run
  (``chip_smoke.TRAIN_DW_RTOL``, ``TRAIN_CV_RTOL``); the rerun writes the
  same bytes;
- ``bench/dp_epoch --against-eager`` at 2x1 and 1x2 (two cards), 2x2
  (four) in float32 and 1x2 in bfloat16: on every rank the replayed
  bunches (one captured CUDA graph per bunch, its collectives inside) bit
  for bit the eager mesh loop's (weights, velocity, alpha), the timed
  epochs' launches and ``Mesh.traffic`` equal to the byte, every bunch of
  the timed epoch a replay;
- the overlapped step (``train_chunk_overlap``) at 4x1 on four cards
  (``chip_smoke.overlap_mesh_runs``): on every rank its replayed bunches
  bit for bit its eager loop's (``graph=False``), launches and
  ``Mesh.traffic`` equal to the byte, every bunch of the timed epoch a
  replay, and a traced window of replayed bunches holding NCCL and GEMM
  kernels;
- ``bench/mesh_decode`` on two cards and on four: every form of
  ``Enhancer(mesh=)`` within 1 int16 LSB and the enhanced LPS within rtol
  1e-5, atol 1e-5 of the one-process decode, the int16 streams of
  ``StreamingEnhancer(mesh=)`` bit for bit, each rank's LPS launches the
  one process's.

Run them on a machine with several cards with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_multicard.py
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_mp_worker import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTER_TIMEOUT_S = 300


def _smoke():
    """``chip_smoke.py`` as a module (its checks and fixtures)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def _need_cards(n: int) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA cards (NCCL, one rank per card)")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards, has "
                    f"{torch.cuda.device_count()}")


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The training fixtures, the full-width init and the one-process card
    run at lrate 0.001 that the meshes are held to."""
    _need_cards(2)
    c = _smoke()
    root = str(tmp_path_factory.mktemp("multicard"))
    tfx = c.write_train_fixtures(root, c.SEED)
    init_wts = os.path.join(root, "init.wts")
    assert c.cli_main(["gen-rand-net", "-o", init_wts, "--seed",
                       str(c.SEED)]) == 0
    c.run_train(tfx, init_wts, os.path.join(root, "one"), "cuda",
                "--lrate", c.AGREE_LRATE)
    return {"root": root, "tfx": tfx, "init_wts": init_wts}


def _train_cluster(c, fx, data, model, name) -> list[str]:
    from tpu_se_torch.parallel.mesh import free_port

    n, port = data * model, free_port()
    out = os.path.join(fx["root"], name)
    codes, logs = run_ranks(lambda k: c.train_rank_argv(
        fx["tfx"], fx["init_wts"], out, "--lrate", c.AGREE_LRATE,
        "--mesh-model", str(model),
        *c.coordinator_flags(port, n, k, False)), n,
        timeout=CLUSTER_TIMEOUT_S)
    assert codes == [0] * n, "\n----\n".join(logs)
    return logs


@pytest.mark.cuda
@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)],
                         ids=["1x2", "2x2"])
def test_model_axis_training_matches_one_process(one_process, data, model):
    _need_cards(data * model)
    c = _smoke()
    fx = one_process
    name = f"nccl{data}x{model}"
    for run in (name, f"{name}_again"):
        logs = _train_cluster(c, fx, data, model, run)
        for k, text in enumerate(logs):
            assert (f"data mesh: data={data}, model={model}, rank {k} on "
                    f"cuda:{k} (nccl)") in text
            c.check_mesh_line(text, f"{run} rank {k}", c.tp_want(
                fx["tfx"], fx["init_wts"], data, model, k, "nccl"))
        c.rank0_files(os.path.join(fx["root"], run), run)
    one = os.path.join(fx["root"], "one")
    got = os.path.join(fx["root"], name)
    assert c.worst_change(fx["init_wts"], one, got) <= c.TRAIN_DW_RTOL
    assert c.worst_cv(one, got) <= c.TRAIN_CV_RTOL
    assert c.same_bytes(os.path.join(got, "mlp.2.wts"),
                        os.path.join(fx["root"], f"{name}_again",
                                     "mlp.2.wts"))


@pytest.mark.cuda
@pytest.mark.parametrize("data,model,dtype", [
    (2, 1, "float32"), (1, 2, "float32"), (2, 2, "float32"),
    (1, 2, "bfloat16")], ids=["2x1", "1x2", "2x2", "1x2_bf16"])
def test_replayed_mesh_bunches_equal_the_eager_loop(tmp_path, data, model,
                                                    dtype):
    _need_cards(data * model)
    c = _smoke()
    from tpu_se_torch.parallel.mesh import free_port

    tfx = c.write_train_fixtures(str(tmp_path), c.SEED)
    init_wts = str(tmp_path / "init.wts")
    assert c.cli_main(["gen-rand-net", "-o", init_wts, "--seed",
                       str(c.SEED)]) == 0
    n, port = data * model, free_port()
    codes, logs = run_ranks(lambda k: [
        "-m", "tpu_se_torch.bench.dp_epoch", "--fea-file", tfx["noisy"],
        "--targ-file", tfx["clean"], "--norm-file", tfx["norm"],
        "--init-wts", init_wts, "--train-sents", tfx["train_sents"],
        "--traincache", str(tfx["traincache"]), "--device", "cuda",
        "--mesh-model", str(model), "--compute-dtype", dtype,
        "--against-eager", *c.coordinator_flags(port, n, k, False)], n,
        timeout=CLUSTER_TIMEOUT_S)
    assert codes == [0] * n, "\n----\n".join(logs)
    for k, text in enumerate(logs):
        r = json.loads(text.strip().splitlines()[-1])
        assert (r["rank"], r["data"], r["model"]) == (k, data, model)
        c.against_eager(r, f"{data}x{model} {dtype} rank {k}")
        assert r["bunches_replayed"] == r["bunches"] > 0


@pytest.mark.cuda
def test_overlapped_4x1_replays_its_eager_loop(tmp_path):
    _need_cards(4)
    c = _smoke()
    tfx = c.write_train_fixtures(str(tmp_path), c.SEED)
    init_wts = str(tmp_path / "init.wts")
    assert c.cli_main(["gen-rand-net", "-o", init_wts, "--seed",
                       str(c.SEED)]) == 0
    launches = c.overlap_mesh_runs(str(tmp_path), {
        "tfx": tfx, "init_wts": init_wts}, 4, ("float32",), True, "4x1")
    # Three states of three epochs each on every rank, and the traces.
    assert (launches["colsum"] == launches["from_sums"] == launches["sgd"]
            > 4 * 9 * c.ml_bunches(tfx))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4], ids=["two_ranks", "four_ranks"])
def test_mesh_decode_matches_one_process(tmp_path, n):
    """``bench/mesh_decode`` on n cards against one process: every form
    within 1 LSB, the int16 streams bit for bit, LPS launches equal.  At 4
    ranks (2 channels a rank) the streams were 1 LSB off one process's
    until every rank ran the network at all the mesh's rows."""
    _need_cards(n)
    c = _smoke()
    from tpu_se_torch.ops import lps_kernel
    from tpu_se_torch.parallel.mesh import free_port

    fx = c.write_fixtures(str(tmp_path))
    problem, path = c.mesh_problem(str(tmp_path), fx)
    lps_kernel.launches = 0
    one = c.decode_all(fx["wts"], fx["norm"], problem, None, "cuda")
    torch.cuda.synchronize()
    one_launches = lps_kernel.launches
    port = free_port()
    codes, logs = run_ranks(lambda k: [
        "-m", "tpu_se_torch.bench.mesh_decode", "--wts", fx["wts"],
        "--norm", fx["norm"], "--problem", path, "--out", str(tmp_path),
        "--device", "cuda", *c.coordinator_flags(port, n, k, False)], n,
        timeout=CLUSTER_TIMEOUT_S)
    assert codes == [0] * n, "\n----\n".join(logs)
    c.decoder_launches(logs, one_launches, "decoder rank")
    got = [dict(np.load(os.path.join(tmp_path, f"mesh_decode.{k}.npz")))
           for k in range(n)]
    lsb, _, bitwise = c.hold_decode(got, one, f"{n} decoder ranks over NCCL")
    assert lsb <= 1
    assert bitwise["stream"]

