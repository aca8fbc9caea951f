"""tpu_se_torch.parallel.overlap_step against tpu_se's, on the CPU.

The port's twin of the overlap cases of ``tests/test_parallel.py``
(:248-330), on the same problem (``tests/test_torch_parallel.py:_problem``:
(24, 16, 16, 8), 4 bunches of 16, lr 0.05):

- ``mesh=None``: against ``tpu_se.parallel.overlap_step.
  train_chunk_overlap(mesh=None)`` at ``tpu_se``'s tolerance (rtol 2e-5,
  atol 1e-7) for (ml, activation) in {(T, sigmoid), (F, sigmoid),
  (T, relu)}, and bit for bit against the port's own ``train_chunk`` (in
  float32 every operation is the one autograd runs); in bfloat16 against
  ``tpu_se``'s bfloat16 overlap step at the bf16 tolerance;
- 2 gloo ranks (``tests/torch_mp_worker.py overlap``): against
  ``tpu_se``'s overlap step under ``make_mesh(2, 1)`` on the virtual CPU
  devices at rtol 2e-4, atol 1e-6 (the flat step's bar,
  ``tests/test_torch_parallel.py``).  ``tpu_se``'s step threads its ``tok``
  chain through the psums and the port's has none: the comparison shows
  it changes nothing compared.  At 2 ranks each sum is one addition, so
  the overlapped step is the flat step bit for bit;
- the bfloat16 ring at 2 ranks, on ``tests/test_parallel.py:304-330``'s
  problem (seed 5): against the port's bfloat16 ``train_chunk(mesh=)`` at
  rtol 3e-2, atol 1e-4, as the reference holds its ring to its GSPMD
  step (the ring rounds ``dW`` to bfloat16 and keeps ``dedy`` in float32,
  where the flat step rounds ``g`` and ``dh`` too), and against
  ``tpu_se``'s ring at the float32 bar (measured: within 2.1e-5 of the
  bfloat16 bar over four seeds; the two flat steps, the port's and
  ``tpu_se``'s GSPMD one, stand at up to 1.03 of it at seed 3);
- the collectives: one all-reduce per layer per bunch plus one of the D
  column sums (ML), the flat step's bytes; ``Mesh.all_reduce_sum_async``
  sums bfloat16 (gloo) and two sums can be in flight at once;
- the refusals of ``tpu_se``: dropout, ``act_dtype``, a model axis > 1;
- ``graph=True`` against ``graph=False`` on the CPU, where both are the
  eager loop: the same bits.  The replay rule is ``train_chunk``'s
  (``tests/test_torch_train_graph.py:test_replay_rule``), and the
  replayed step on a card is held to its eager loop there (``cuda``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_se.parallel as ref_parallel
import tpu_se.train as ref_train
from test_torch_parallel import HYPER, LR, _problem
from torch_mp_worker import run_ranks
from tpu_se.parallel.overlap_step import (
    shard_overlap_args as ref_shard_overlap_args,
    train_chunk_overlap as ref_train_chunk_overlap,
)
from tpu_se_torch import train
from tpu_se_torch.models import params_from_numpy
from tpu_se_torch.parallel.mesh import Mesh, free_port
from tpu_se_torch.parallel.overlap_step import (
    shard_overlap_args, train_chunk_overlap,
)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mp_worker.py")
RANKS = 2
# tpu_se's tolerances (tests/test_parallel.py:248-330).
ONE = dict(rtol=2e-5, atol=1e-7)
MESHED = dict(rtol=2e-4, atol=1e-6)
BF16 = dict(rtol=3e-2, atol=1e-4)
BF16_HYPER = dict(compute_dtype="bfloat16", grad_scale="natural")


def _port(step, problem, ml, activation="sigmoid", **hyper):
    noisy, clean, starts, layers = problem
    state = train.make_train_state(
        params_from_numpy(layers, "cpu", activation=activation))
    step(state, torch.from_numpy(noisy), torch.from_numpy(clean),
         torch.from_numpy(starts.astype(np.int64)), LR,
         train.TrainHyper(ml=ml, activation=activation,
                          **{**HYPER, **hyper}))
    return state


def _tpu_se(problem, ml, activation="sigmoid", size=None, **hyper):
    noisy, clean, starts, layers = problem
    if hyper.get("compute_dtype") == "bfloat16":
        hyper = {**hyper, "compute_dtype": jnp.bfloat16}
    ref_hyper = ref_train.TrainHyper(ml=ml, activation=activation,
                                     **{**HYPER, **hyper})
    params = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    state = ref_train.make_train_state(params, layers[-1]["b"].shape[0])
    mesh = None
    if size is not None:
        mesh = ref_parallel.make_mesh(size, 1)
        noisy, clean, starts = ref_shard_overlap_args(mesh, noisy, clean,
                                                      starts)
    return ref_train_chunk_overlap(
        state, jnp.asarray(noisy), jnp.asarray(clean), jnp.asarray(starts),
        jnp.float32(LR), ref_hyper, mesh=mesh)


def _layers(state) -> list[dict]:
    return [{k: v.detach().numpy() for k, v in layer.items()}
            for layer in train.param_layers(state.model)]


@pytest.mark.parametrize("ml,activation", [(True, "sigmoid"),
                                           (False, "sigmoid"),
                                           (True, "relu")])
def test_overlap_step_unsharded_matches_tpu_se_and_train_chunk(
        ml, activation):
    problem = _problem()
    got = _port(train_chunk_overlap, problem, ml, activation)
    want = _tpu_se(problem, ml, activation)
    for mine, ref in zip(_layers(got), want.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(mine[k], np.asarray(ref[k]), **ONE)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=1e-5)
    flat = _port(train.train_chunk, problem, ml, activation)
    for a, b in zip(got.model.parameters(), flat.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(got.alpha, flat.alpha)
    assert not torch.equal(got.model.weights[0],
                           params_from_numpy(problem[3], "cpu").weights[0])


def test_overlap_step_unsharded_bf16_matches_tpu_se():
    problem = _problem(seed=5)
    got = _port(train_chunk_overlap, problem, True, **BF16_HYPER)
    want = _tpu_se(problem, True, **BF16_HYPER)
    for mine, ref in zip(_layers(got), want.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(mine[k], np.asarray(ref[k]), **BF16)
    # Not the float32 step: the products' operands were rounded.
    fp32 = _port(train_chunk_overlap, problem, True, grad_scale="natural")
    assert not torch.equal(got.model.weights[0], fp32.model.weights[0])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One cluster of 2 gloo ranks over every case -> (what rank 0 saved,
    {"problem": float32 problem, "problem_bf16": bfloat16 problem})."""
    if len(jax.devices()) < RANKS:
        pytest.skip(f"need {RANKS} virtual devices")
    where = tmp_path_factory.mktemp("overlap")
    # tests/test_parallel.py's seeds: 3 for the DP overlap case, 5 for bf16.
    problems = {"problem": _problem(seed=3), "problem_bf16": _problem(seed=5)}
    for name, (noisy, clean, starts, layers) in problems.items():
        arrays = {"noisy": noisy, "clean": clean, "starts": starts,
                  "lr": LR, "context": HYPER["context"],
                  "targ_offset": HYPER["targ_offset"]}
        for i, layer in enumerate(layers):
            arrays[f"w{i}"], arrays[f"b{i}"] = layer["w"], layer["b"]
        np.savez(where / f"{name}.npz", **arrays)
    port = free_port()
    codes, logs = run_ranks(
        lambda k: [WORKER, "overlap", str(k), str(RANKS), str(port),
                   str(where)], RANKS, timeout=150)
    assert codes == [0] * RANKS, "\n".join(logs)
    with np.load(where / "overlap.npz") as z:
        return dict(z), problems


def _saved(got, run, n_layers):
    return [{k: got[f"{run}_{k}{i}"] for k in ("w", "b")}
            for i in range(n_layers)]


@pytest.mark.parametrize("ml", [True, False])
def test_overlap_step_over_gloo_ranks_matches_tpu_se(two_ranks, ml):
    got, problems = two_ranks
    problem = problems["problem"]
    case = "ml1" if ml else "ml0"
    want = _tpu_se(problem, ml, size=RANKS)
    mine = _saved(got, f"{case}_overlap", len(problem[3]))
    for layer, ref in zip(mine, want.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(layer[k], np.asarray(ref[k]),
                                       **MESHED)
    np.testing.assert_allclose(got[f"{case}_overlap_alpha"],
                               np.asarray(want.alpha), rtol=1e-4)
    # Two ranks: each sum is one addition, whatever the message's size.
    for layer, flat in zip(mine, _saved(got, f"{case}_flat",
                                        len(problem[3]))):
        for k in ("w", "b"):
            np.testing.assert_array_equal(layer[k], flat[k])


def test_overlap_bf16_ring_over_gloo_ranks_matches_the_flat_bf16_step(
        two_ranks):
    got, problems = two_ranks
    problem = problems["problem_bf16"]
    n_layers = len(problem[3])
    ring = _saved(got, "bf16_overlap", n_layers)
    flat = _saved(got, "bf16_flat", n_layers)
    for a, b in zip(ring, flat):
        np.testing.assert_allclose(a["w"], b["w"], **BF16)
    assert np.isfinite(got["bf16_overlap_alpha"]).all()
    want = _tpu_se(problem, True, size=RANKS, **BF16_HYPER)
    for a, ref in zip(ring, want.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k], np.asarray(ref[k]), **MESHED)
    assert not np.array_equal(ring[0]["w"], problem[3][0]["w"])


@pytest.mark.parametrize("case,per_layer", [("ml1", 1), ("ml0", 1),
                                            ("bf16", 2)])
def test_overlap_collectives_per_bunch(two_ranks, case, per_layer):
    got, problems = two_ranks
    _, _, starts, layers = problems["problem_bf16" if case == "bf16"
                                    else "problem"]
    n_bunches, n_layers = len(starts), len(layers)
    calls, sent = got[f"{case}_overlap_traffic"]
    flat_calls, flat_sent = got[f"{case}_flat_traffic"]
    column_sums = 1 if case != "ml0" else 0
    assert calls == n_bunches * (per_layer * n_layers + column_sums)
    assert flat_calls == n_bunches * (1 + column_sums)
    n_params = sum(l["w"].size + l["b"].size for l in layers)
    if case == "bf16":
        # dW in bfloat16 (2 bytes), db and the column sums in float32.
        n_w = sum(l["w"].size for l in layers)
        assert sent == n_bunches * (2 * n_w + 4 * (n_params - n_w)
                                    + 4 * layers[-1]["b"].size)
    else:
        assert sent == flat_sent == n_bunches * 4 * (
            n_params + column_sums * layers[-1]["b"].size)


def test_all_reduce_sum_async_over_gloo_ranks(two_ranks):
    got, _ = two_ranks
    half = torch.tensor([1.0, 2.0 ** -8, 3.0, -0.5], dtype=torch.bfloat16)
    want = (half + half * 2).float().numpy()   # one bfloat16 rounding
    np.testing.assert_array_equal(got["bf16_sum"], want)
    np.testing.assert_array_equal(got["f32_sum"],
                                  np.arange(5, dtype=np.float32) * 3)


def test_all_reduce_sum_async_alone_and_refusals():
    mesh = Mesh(0, 1, "cpu", None)
    t = torch.arange(4, dtype=torch.float32)
    assert mesh.all_reduce_sum_async(t).wait() is t
    assert mesh.all_reduce_calls == 0
    group = Mesh(0, 2, "cpu", "gloo")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        group.all_reduce_sum_async(t.double())
    with pytest.raises(ValueError, match="contiguous"):
        group.all_reduce_sum_async(torch.zeros(3, 2).t())


@pytest.mark.parametrize("hyper,kwargs,match", [
    (dict(dropout=(0.1, 0.1)), {}, "dropout"),
    ({}, dict(generator=torch.Generator().manual_seed(0)), "dropout"),
    (dict(act_dtype="bfloat16"), {}, "act_dtype"),
    ({}, dict(mesh=Mesh(0, 2, "cpu", None, model=2)), "model axis"),
], ids=["dropout", "generator", "act_dtype", "model-axis"])
def test_overlap_step_refusals(hyper, kwargs, match):
    noisy, clean, starts, layers = _problem()
    state = train.make_train_state(params_from_numpy(layers, "cpu"))
    before = [p.clone() for p in state.model.parameters()]
    with pytest.raises(NotImplementedError, match=match):
        train_chunk_overlap(state, torch.from_numpy(noisy),
                            torch.from_numpy(clean),
                            torch.from_numpy(starts.astype(np.int64)), LR,
                            train.TrainHyper(ml=True, **{**HYPER, **hyper}),
                            **kwargs)
    assert all(torch.equal(a, b)
               for a, b in zip(before, state.model.parameters()))


def test_shard_overlap_args_is_the_reference_layout():
    noisy, clean, starts, _ = _problem()
    n, c, mine = shard_overlap_args(Mesh(1, 2, "cpu", None), noisy, clean,
                                    torch.from_numpy(starts))
    assert n is noisy and c is clean
    np.testing.assert_array_equal(mine.numpy(), starts[:, 8:])
    with pytest.raises(ValueError, match="got 16 columns of starts"):
        train_chunk_overlap(
            train.make_train_state(params_from_numpy(_problem()[3], "cpu")),
            torch.from_numpy(noisy), torch.from_numpy(clean),
            torch.from_numpy(starts.astype(np.int64)), LR,
            train.TrainHyper(ml=True, **HYPER), mesh=Mesh(0, 2, "cpu", None))


@pytest.mark.parametrize("hyper", [{}, BF16_HYPER], ids=["fp32", "bf16"])
def test_overlap_graph_flag_changes_nothing_on_the_cpu(hyper):
    noisy, clean, starts, layers = _problem()
    states = {}
    for graph in (True, False):
        states[graph] = train.make_train_state(
            params_from_numpy(layers, "cpu"))
        train_chunk_overlap(states[graph], torch.from_numpy(noisy),
                            torch.from_numpy(clean),
                            torch.from_numpy(starts.astype(np.int64)), LR,
                            train.TrainHyper(ml=True, **{**HYPER, **hyper}),
                            graph=graph)
    assert states[True]._graph is None
    for a, b in zip(states[True].model.parameters(),
                    states[False].model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(states[True].velocity, states[False].velocity):
        assert all(torch.equal(a[k], b[k]) for k in ("w", "b"))
    assert torch.equal(states[True].alpha, states[False].alpha)
