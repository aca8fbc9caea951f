"""``train_chunk``'s captured bunch (``graph=True``, the default) against
its eager loop (``graph=False``) and against ``tpu_se.train``.

On the CPU there are no graphs: ``graph=True`` runs the eager loop, so the
two flags give the same bits (with dropout masks too, the generators left
in the same state), the counters of replays, captures and GGD kernel
launches stay where they were, and no graph is kept on the state.  The
rule that picks the replay (a card, no mesh or an NCCL one; masks or
none) is checked on device descriptors and stand-in meshes; that both
steps, flat and overlapped, go through ``run_chunk`` with their names and
the masks' generator, on a stand-in replay; the bookkeeping that keeps a
capture out of the counters and adds each replay's launches and
collectives on the module counters and a ``Mesh.traffic`` of plain dicts;
and a state's graph key on CPU tensors: it follows a mesh's flat buffer,
and tells masks from none and the flat step from the overlapped one.  The default call is held to
``tpu_se.train.train_chunk`` at a narrow width (1799, 64, 64, 257), M=32,
three bunches: rtol 2e-5, atol 1e-6 (float32 GEMMs summed in another
order, compounded over three bunches: ``tests/test_torch_train.py``'s bar
for a chunk).

On a card (tests marked ``cuda``; no JAX there) every comparison is bit
for bit, float32 and bfloat16 products, M=128 at the same width: the
replayed chunk against the eager one (weights, velocity, alpha); one call
per bunch against one call over all; two chunks with another rate between
them (one capture); new frames (a second capture); a fresh state (its own
graph, the first state's kept).  Counts: GGD kernel launches = bunches,
replays = bunches - warm-ups, one warm-up per capture.  And one NCCL rank
on the card (a 1x1 mesh, ``torch.distributed`` in this process): the
replayed chunk bit for bit the eager one in float32 and bfloat16, the
split GGD and optimizer launches and ``Mesh.traffic`` the eager run's to
the byte.  With dropout masks (0.1, 0.1): the replayed chunk against
the eager one in float32 and bfloat16, the generator's offset after each
equal; two chunks with a generator each (one capture, the offsets equal
after each chunk, the weights not those of a chunk without masks), and a
chunk without masks after them (a capture anew); one NCCL rank with masks.
The overlapped step (``train_chunk_overlap``): replayed against its eager
loop in float32 and bfloat16, against the replayed flat step in float32
(bit for bit at ``mesh=None``), a state that switches steps (a capture
per switch), and one NCCL rank against its eager loop, launches and
``Mesh.traffic`` equal.  Run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_graph.py
"""

import numpy as np
import pytest
import torch

from tpu_se_torch.models import init_params, params_from_numpy
from tpu_se_torch.ops import ggd_kernel, sgd_kernel
from tpu_se_torch.parallel.mesh import Mesh
from tpu_se_torch.parallel.overlap_step import train_chunk_overlap
from tpu_se_torch.train import TrainHyper, make_train_state, param_layers
from tpu_se_torch.train import step
from tpu_se_torch.train.step import train_chunk

NARROW = (1799, 64, 64, 257)
LR = 0.1
# The reference's (visible_omit, hid_omit) defaults (finetune.pl:75-76).
DROPOUT = (0.1, 0.1)


def _problem(seed, m, n_bunches, n_frames=1024):
    """Seeded frames [F, 257], window starts [n_bunches, M] and the
    narrow network's numpy layers."""
    rng = np.random.default_rng(seed)
    noisy = rng.normal(size=(n_frames, 257)).astype(np.float32)
    clean = (0.8 * noisy + rng.normal(scale=0.1, size=noisy.shape)
             ).astype(np.float32)
    starts = rng.integers(0, n_frames - 7, size=(n_bunches, m))
    return noisy, clean, starts.astype(np.int64), init_params(seed + 1,
                                                              NARROW)


def _hyper(m, compute_dtype="float32", dropout=None):
    return TrainHyper(beta=1.0, ml=True, bunchsize=m, context=7,
                      targ_offset=3, grad_scale="parity",
                      compute_dtype=compute_dtype, dropout=dropout)


def _tensors(state):
    """Every tensor the step writes, host copies in a fixed order."""
    out = [t.detach().cpu() for layer in param_layers(state.model)
           for t in layer.values()]
    out += [t.cpu() for layer in state.velocity for t in layer.values()]
    return out + [state.alpha.cpu()]


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert torch.equal(x, y), f"tensor {i} differs"


def _counts():
    return (ggd_kernel.launches, step.bunches_replayed, step.graphs_captured)


def _delta(before):
    return tuple(b - a for a, b in zip(before, _counts()))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_graph_flag_changes_nothing_on_the_cpu(compute_dtype):
    noisy, clean, starts, layers = _problem(0, 32, 3)
    args = (torch.from_numpy(noisy), torch.from_numpy(clean),
            torch.from_numpy(starts), LR, _hyper(32, compute_dtype))
    before = _counts()
    graphed = train_chunk(make_train_state(params_from_numpy(layers, "cpu")),
                          *args)
    eager = train_chunk(make_train_state(params_from_numpy(layers, "cpu")),
                        *args, graph=False)
    _assert_same(graphed, eager)
    assert graphed._graph is None
    assert _delta(before) == (0, 0, 0)


def test_graph_default_matches_jax_on_the_cpu():
    import jax.numpy as jnp

    import tpu_se.train as ref_train

    noisy, clean, starts, layers = _problem(1, 32, 3)
    kw = dict(beta=1.0, ml=True, momentum=0.9, weightcost=1e-5, bunchsize=32,
              context=7, targ_offset=3, grad_scale="parity")
    want = ref_train.train_chunk(
        ref_train.make_train_state(
            [{k: jnp.asarray(v) for k, v in layer.items()}
             for layer in layers], 257),
        jnp.asarray(noisy), jnp.asarray(clean),
        jnp.asarray(starts.astype(np.int32)), jnp.float32(LR),
        ref_train.TrainHyper(**kw))
    got = train_chunk(make_train_state(params_from_numpy(layers, "cpu")),
                      torch.from_numpy(noisy), torch.from_numpy(clean),
                      torch.from_numpy(starts), LR, TrainHyper(**kw))
    for p, v, w, u in zip(param_layers(got.model), got.velocity,
                          want.params, want.velocity):
        for k in ("w", "b"):
            np.testing.assert_allclose(p[k].detach().numpy(),
                                       np.asarray(w[k]), rtol=2e-5, atol=1e-6)
            np.testing.assert_allclose(v[k].numpy(), np.asarray(u[k]),
                                       rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=2e-5)


def _stand_in(backend, size=1, model=1, device="cuda"):
    """A ``Mesh`` as rank 0 of ``size`` would hold it, without a group."""
    return Mesh(0, size, device, backend, model=model)


@pytest.mark.parametrize("device,mesh,dropout,want", [
    ("cuda", None, None, True),
    ("cuda:1", None, None, True),
    ("cpu", None, None, False),
    ("cuda", ("nccl", 1, 1), None, True),
    ("cuda", ("nccl", 4, 1), None, True),
    ("cuda", ("nccl", 2, 2), None, True),
    ("cuda", ("nccl", 4, 4), None, True),
    ("cuda", ("gloo", 2, 1), None, False),
    ("cuda", ("gloo", 4, 2), None, False),
    ("cuda", ("nccl", 2, 1), (0.1, 0.2), True),
    ("cpu", ("gloo", 2, 1), None, False),
    ("cuda", None, (0.1, 0.2), True),
    ("cpu", ("gloo", 1, 1), (0.1, 0.2), False),
])
def test_replay_rule(device, mesh, dropout, want):
    """The device and the mesh's backend decide; dropout masks do not
    (the captured bunch draws them), so each row reads the same with
    ``dropout`` set or not."""
    mesh = None if mesh is None else _stand_in(*mesh)
    assert step._replays(torch.device(device), mesh) is want


@pytest.mark.parametrize("kind,masks", [
    ("flat", False), ("flat", True), ("overlap", False)])
def test_both_steps_replay_through_run_chunk(monkeypatch, kind, masks):
    """With the rule forced true on CPU tensors, the flat and the
    overlapped step hand their chunk to ``_replay_chunk`` under their own
    names, with the masks' generator only where masks are drawn; with
    ``graph=False`` neither does."""
    calls = []

    def replay(state, noisy, clean, starts, lr, hyper, bunch_step, params,
               mesh, generator, name):
        calls.append((name, generator, starts.shape[0]))
        return state.alpha

    monkeypatch.setattr(step, "_replays", lambda device, mesh: True)
    monkeypatch.setattr(step, "_replay_chunk", replay)
    noisy, clean, starts, layers = _problem(12, 16, 2)
    args = (torch.from_numpy(noisy), torch.from_numpy(clean),
            torch.from_numpy(starts), LR)
    gen = torch.Generator().manual_seed(3) if masks else None
    hyper = TrainHyper(beta=1.0, bunchsize=16,
                       dropout=(0.1, 0.1) if masks else None)
    fn = train_chunk if kind == "flat" else train_chunk_overlap
    state = make_train_state(params_from_numpy(layers, "cpu"))
    fn(state, *args, hyper, generator=gen)
    assert calls == [(kind, gen, 2)]
    # hyper.dropout without a generator draws no masks.
    if masks:
        train_chunk(state, *args, hyper)
        assert calls[-1] == ("flat", None, 2)
    calls.clear()
    before = [p.clone() for p in state.model.parameters()]
    fn(state, *args, hyper, generator=gen, graph=False)
    assert calls == []
    assert not torch.equal(before[0], state.model.weights[0])


def _traffic_of(mesh):
    return {axis: {op: list(entry) for op, entry in ops.items()}
            for axis, ops in mesh.traffic.items()}


@pytest.mark.parametrize("with_mesh", [False, True])
def test_capture_counts_come_back_and_replays_add_them(with_mesh):
    """``_capture``'s bookkeeping on plain counters: what a captured bunch
    added is read off, taken back, and added once per replay."""
    mesh = _stand_in("nccl", 2, 1) if with_mesh else None
    traffic = None if mesh is None else mesh.traffic
    saved = step.read_counts(None)
    try:
        if mesh is not None:
            mesh.traffic["data"]["all_reduce"][:] = [5, 50]
        start = step.read_counts(traffic)
        width = 4 + (8 if with_mesh else 0)
        assert len(start) == width

        # One bunch "captured": two split GGD launches, one update, and
        # under the mesh two all-reduces and a model-axis gather.
        ggd_kernel.colsum_launches += 1
        ggd_kernel.grad_from_sums_launches += 1
        sgd_kernel.launches += 1
        if mesh is not None:
            mesh._count("data", "all_reduce", torch.zeros(257))
            mesh._count("data", "all_reduce", torch.zeros(3, 7))
            mesh._count("model", "all_gather", torch.zeros(2, 2))
        delta = tuple(b - a for a, b in zip(start, step.read_counts(traffic)))
        step.add_counts(traffic, delta, -1)
        assert step.read_counts(traffic) == start

        step.add_counts(traffic, delta, 3)
        now = step.read_counts(traffic)
        assert now[:4] == (start[0], start[1] + 3, start[2] + 3,
                           start[3] + 3)
        if mesh is not None:
            assert mesh.traffic["data"]["all_reduce"] == [
                5 + 3 * 2, 50 + 3 * 4 * (257 + 21)]
            assert mesh.traffic["data"]["all_gather"] == [0, 0]
            assert mesh.traffic["model"]["all_reduce"] == [0, 0]
            assert mesh.traffic["model"]["all_gather"] == [3, 3 * 16]
            assert mesh.all_reduce_calls == 11
    finally:
        step.add_counts(None, tuple(
            a - b for a, b in zip(saved, step.read_counts(None))))
    assert step.read_counts(None) == saved


def test_a_mesh_graph_key_follows_the_flat_buffer():
    """A mesh state's graph key names the mesh's flat gradient buffer: a
    buffer allocated anew (another size, say) changes the key, and the
    key holds the buffer, so its memory cannot be handed out again."""
    noisy, clean, starts, layers = _problem(9, 16, 1)
    state = make_train_state(params_from_numpy(layers, "cpu"))
    params = [p for layer in param_layers(state.model)
              for p in (layer["w"], layer["b"])]
    mesh = _stand_in("nccl", 2, 1, "cpu")
    frames = torch.from_numpy(noisy), torch.from_numpy(clean)
    hyper = _hyper(16)
    n = sum(p.numel() for p in params)

    def key():
        return step._graph_key(state, *frames, params, 16, hyper, mesh)

    plain, _ = step._graph_key(state, *frames, params, 16, hyper)
    mesh._flat = torch.empty(n)
    first, held = key()
    assert first == key()[0] and first != plain
    assert any(t is mesh._flat for t in held)
    assert any(t is mesh for t in held)
    kept = mesh._flat
    mesh._flat = torch.empty(n)
    assert key()[0] != first
    mesh._flat = kept
    assert key()[0] == first
    mesh._groups["data"] = object()
    assert key()[0] != first


def test_graph_key_tells_masks_and_steps_apart():
    """On the same tensors and ``hyper`` (dropout set), a graph that draws
    masks, one that draws none, and the overlapped step's graph have
    three keys: none may replay another's; the generator is not in the
    key."""
    noisy, clean, starts, layers = _problem(10, 16, 1)
    state = make_train_state(params_from_numpy(layers, "cpu"))
    params = [p for layer in param_layers(state.model)
              for p in (layer["w"], layer["b"])]
    frames = torch.from_numpy(noisy), torch.from_numpy(clean)
    hyper = TrainHyper(beta=1.0, bunchsize=16, dropout=(0.1, 0.1))
    for mesh in (None, _stand_in("nccl", 2, 1, "cpu")):
        keys = {(kind, masks): step._graph_key(
            state, *frames, params, 16, hyper, mesh, kind, masks)[0]
            for kind, masks in (("flat", False), ("flat", True),
                                ("overlap", False))}
        assert len(set(keys.values())) == 3
        assert keys["flat", False] == step._graph_key(
            state, *frames, params, 16, hyper, mesh)[0]
        assert keys["flat", True] == step._graph_key(
            state, *frames, params, 16, hyper, mesh, "flat", True)[0]
    # The overlapped step reads no flat gradient buffer: one allocated by
    # a flat step on the same mesh leaves its key as it was, and the flat
    # step's changes.
    n = sum(p.numel() for p in params)
    flat = step._graph_key(state, *frames, params, 16, hyper, mesh)[0]
    mesh._flat = torch.empty(n)
    assert step._graph_key(state, *frames, params, 16, hyper, mesh,
                           "overlap")[0] == keys["overlap", False]
    assert step._graph_key(state, *frames, params, 16, hyper, mesh)[0] != flat


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_graph_flag_changes_nothing_with_dropout_on_the_cpu(compute_dtype):
    """Masks on the CPU: ``graph=True`` is the eager loop, the same bits
    and the generators left in the same state, over two chunks with a
    generator each."""
    noisy, clean, starts, layers = _problem(11, 16, 2)
    hyper = TrainHyper(beta=1.0, bunchsize=16, dropout=(0.1, 0.2),
                       compute_dtype=compute_dtype)
    args = (torch.from_numpy(noisy), torch.from_numpy(clean),
            torch.from_numpy(starts), LR, hyper)
    states, gens = {}, {}
    for graph in (True, False):
        states[graph] = make_train_state(params_from_numpy(layers, "cpu"))
        gens[graph] = []
        for chunk in range(2):
            gens[graph].append(torch.Generator().manual_seed(20 + chunk))
            train_chunk(states[graph], *args, generator=gens[graph][-1],
                        graph=graph)
    _assert_same(states[True], states[False])
    for a, b in zip(gens[True], gens[False]):
        assert torch.equal(a.get_state(), b.get_state())
    plain = train_chunk(make_train_state(params_from_numpy(layers, "cpu")),
                        *args)
    assert not torch.equal(plain.model.weights[0],
                           states[True].model.weights[0])


def test_dropout_without_a_generator_is_no_dropout():
    """``hyper.dropout`` draws masks only with a generator, so without one
    the chunk is the plain bunch, and a card would replay it."""
    noisy, clean, starts, layers = _problem(2, 16, 2)
    args = (torch.from_numpy(noisy), torch.from_numpy(clean),
            torch.from_numpy(starts), LR)
    with_flag = train_chunk(
        make_train_state(params_from_numpy(layers, "cpu")), *args,
        TrainHyper(beta=1.0, bunchsize=16, dropout=(0.1, 0.2)))
    plain = train_chunk(make_train_state(params_from_numpy(layers, "cpu")),
                        *args, TrainHyper(beta=1.0, bunchsize=16),
                        graph=False)
    _assert_same(with_flag, plain)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def _on_card(card, seed, m=128, n_bunches=5):
    noisy, clean, starts, layers = _problem(seed, m, n_bunches)
    return (torch.from_numpy(noisy).to(card),
            torch.from_numpy(clean).to(card),
            torch.from_numpy(starts).to(card), layers)


def _state(layers, card):
    return make_train_state(params_from_numpy(layers, card))


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_replayed_chunk_equals_eager_on_the_card(card, compute_dtype):
    noisy, clean, starts, layers = _on_card(card, 3)
    hyper = _hyper(128, compute_dtype)
    before = _counts()
    eager = train_chunk(_state(layers, card), noisy, clean, starts, LR,
                        hyper, graph=False)
    assert _delta(before) == (5, 0, 0)
    before = _counts()
    graphed = train_chunk(_state(layers, card), noisy, clean, starts, LR,
                          hyper)
    torch.cuda.synchronize()
    assert _delta(before) == (5, 4, 1)
    assert graphed._graph is not None and eager._graph is None
    _assert_same(graphed, eager)


@pytest.mark.cuda
def test_bunch_calls_equal_one_call_on_the_card(card):
    noisy, clean, starts, layers = _on_card(card, 4)
    hyper = _hyper(128)
    before = _counts()
    per_bunch = _state(layers, card)
    for j in range(starts.shape[0]):
        train_chunk(per_bunch, noisy, clean, starts[j:j + 1], LR, hyper)
    assert _delta(before) == (5, 4, 1)
    whole = train_chunk(_state(layers, card), noisy, clean, starts, LR,
                        hyper)
    eager = train_chunk(_state(layers, card), noisy, clean, starts, LR,
                        hyper, graph=False)
    _assert_same(per_bunch, whole)
    _assert_same(whole, eager)


@pytest.mark.cuda
def test_rate_change_replays_the_same_graph(card):
    noisy, clean, starts, layers = _on_card(card, 5)
    hyper = _hyper(128)
    graphed, eager = _state(layers, card), _state(layers, card)
    before = _counts()
    for lr in (LR, 0.05):
        train_chunk(graphed, noisy, clean, starts, lr, hyper)
        train_chunk(eager, noisy, clean, starts, lr, hyper, graph=False)
    assert _delta(before) == (20, 9, 1)
    _assert_same(graphed, eager)


@pytest.mark.cuda
def test_new_frames_capture_again(card):
    noisy, clean, starts, layers = _on_card(card, 6)
    other, other_clean, _, _ = _on_card(card, 7)
    hyper = _hyper(128)
    graphed, eager = _state(layers, card), _state(layers, card)
    before = _counts()
    for frames in ((noisy, clean), (other, other_clean)):
        train_chunk(graphed, *frames, starts, LR, hyper)
        train_chunk(eager, *frames, starts, LR, hyper, graph=False)
    assert _delta(before) == (20, 8, 2)
    assert graphed._graph.held[1] is other
    _assert_same(graphed, eager)


@pytest.mark.cuda
def test_fresh_state_gets_its_own_graph(card):
    noisy, clean, starts, layers = _on_card(card, 8)
    hyper = _hyper(128)
    first = train_chunk(_state(layers, card), noisy, clean, starts, LR,
                        hyper)
    kept = first._graph
    before = _counts()
    second = train_chunk(_state(layers, card), noisy, clean, starts, LR,
                         hyper)
    assert _delta(before) == (5, 4, 1)
    assert second._graph is not kept and first._graph is kept
    _assert_same(first, second)
    before = _counts()
    train_chunk(first, noisy, clean, starts, LR, hyper)
    train_chunk(second, noisy, clean, starts, LR, hyper, graph=False)
    assert _delta(before) == (10, 5, 0)
    assert first._graph is kept
    _assert_same(first, second)


@pytest.fixture
def nccl_rank(card):
    """A 1x1 mesh over NCCL, its group joined in this process."""
    from tpu_se_torch.parallel import (
        initialize_distributed, make_mesh, shutdown_distributed,
    )
    from tpu_se_torch.parallel.mesh import free_port

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, None, "cuda")
    try:
        yield make_mesh(1, 1, "cuda")
    finally:
        shutdown_distributed()


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_one_nccl_rank_replays_the_eager_mesh_chunk(nccl_rank,
                                                    compute_dtype):
    """Two chunks on one NCCL rank, replayed and eager from the same
    weights: the same bits, the same split GGD and optimizer launches and
    the same ``Mesh.traffic`` to the byte; one capture, every later bunch
    a replay."""
    mesh = nccl_rank
    noisy, clean, starts, layers = _on_card(mesh.device, 10)
    hyper = _hyper(128, compute_dtype)
    states, moved, replays = {}, {}, {}
    for graph in (False, True):
        before = step.read_counts(mesh.traffic)
        done = (step.bunches_replayed, step.graphs_captured)
        states[graph] = _state(layers, mesh.device)
        for _ in range(2):
            train_chunk(states[graph], noisy, clean, starts, LR, hyper,
                        mesh=mesh, graph=graph)
        torch.cuda.synchronize()
        moved[graph] = [b - a for a, b in
                        zip(before, step.read_counts(mesh.traffic))]
        replays[graph] = (step.bunches_replayed - done[0],
                          step.graphs_captured - done[1])
    _assert_same(states[True], states[False])
    assert replays == {False: (0, 0), True: (9, 1)}
    assert moved[True] == moved[False]
    n_params = sum(t.numel() for t in _tensors(states[True])[:6])
    bunches = 2 * starts.shape[0]
    # fused GGD, column sums, gradient from sums, updates; then the data
    # axis' all-reduces (the column sums and the flat gradients) and
    # nothing else.
    assert moved[True] == [0, bunches, bunches, bunches,
                           2 * bunches, bunches * 4 * (257 + n_params),
                           0, 0, 0, 0, 0, 0]
    assert states[True]._graph is not None and states[False]._graph is None


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_replayed_dropout_chunk_equals_eager_on_the_card(card,
                                                         compute_dtype):
    """Masks drawn inside the graph: the same bits as the eager chunk's,
    and the generator left at the eager loop's offset."""
    noisy, clean, starts, layers = _on_card(card, 13)
    hyper = _hyper(128, compute_dtype, DROPOUT)
    states, gens = {}, {}
    before = _counts()
    for graph in (False, True):
        gens[graph] = _gen(card, 31)
        states[graph] = train_chunk(_state(layers, card), noisy, clean,
                                    starts, LR, hyper,
                                    generator=gens[graph], graph=graph)
    torch.cuda.synchronize()
    assert _delta(before) == (10, 4, 1)
    _assert_same(states[True], states[False])
    assert gens[True].get_offset() == gens[False].get_offset() > 0


@pytest.mark.cuda
def test_dropout_chunks_with_their_own_generators_on_the_card(card):
    """Two chunks, a generator each (as ``train_one_epoch`` makes them):
    one capture for both, each generator at the eager loop's offset after
    its chunk, weights not those of chunks without masks; then a chunk
    without masks on the same tensors captures anew, and masks again
    once more."""
    noisy, clean, starts, layers = _on_card(card, 14)
    hyper = _hyper(128, dropout=DROPOUT)
    states = {graph: _state(layers, card) for graph in (True, False)}
    before = _counts()
    for chunk in range(2):
        gens = {}
        for graph in (True, False):
            gens[graph] = _gen(card, 40 + chunk)
            train_chunk(states[graph], noisy, clean, starts, LR, hyper,
                        generator=gens[graph], graph=graph)
        assert gens[True].get_offset() == gens[False].get_offset() > 0
    torch.cuda.synchronize()
    assert _delta(before) == (20, 9, 1)
    _assert_same(states[True], states[False])
    plain = _state(layers, card)
    for _ in range(2):
        train_chunk(plain, noisy, clean, starts, LR, hyper)
    assert not torch.equal(plain.model.weights[0],
                           states[True].model.weights[0])
    before = _counts()
    for graph in (True, False):
        train_chunk(states[graph], noisy, clean, starts, LR, hyper,
                    graph=graph)
    gens = {graph: _gen(card, 42) for graph in (True, False)}
    for graph in (True, False):
        train_chunk(states[graph], noisy, clean, starts, LR, hyper,
                    generator=gens[graph], graph=graph)
    torch.cuda.synchronize()
    assert _delta(before) == (20, 8, 2)
    assert gens[True].get_offset() == gens[False].get_offset()
    _assert_same(states[True], states[False])


def _nccl_chunks(mesh, fn, layers, frames, starts, hyper, seeds=()):
    """Two chunks of ``fn`` on one NCCL rank, replayed and eager from the
    same weights (a generator per chunk from ``seeds``) -> (states,
    counts moved, (replays, captures), generator offsets) per graph."""
    states, moved, replays, offsets = {}, {}, {}, {}
    for graph in (False, True):
        before = step.read_counts(mesh.traffic)
        done = (step.bunches_replayed, step.graphs_captured)
        states[graph] = _state(layers, mesh.device)
        offsets[graph] = []
        for chunk in range(2):
            gen = _gen(mesh.device, seeds[chunk]) if seeds else None
            fn(states[graph], *frames, starts, LR, hyper, mesh=mesh,
               graph=graph,
               **({} if gen is None else {"generator": gen}))
            offsets[graph].append(None if gen is None else gen.get_offset())
        torch.cuda.synchronize()
        moved[graph] = [b - a for a, b in
                        zip(before, step.read_counts(mesh.traffic))]
        replays[graph] = (step.bunches_replayed - done[0],
                          step.graphs_captured - done[1])
    return states, moved, replays, offsets


@pytest.mark.cuda
def test_one_nccl_rank_replays_the_eager_mesh_chunk_with_dropout(nccl_rank):
    mesh = nccl_rank
    noisy, clean, starts, layers = _on_card(mesh.device, 15)
    states, moved, replays, offsets = _nccl_chunks(
        mesh, train_chunk, layers, (noisy, clean), starts,
        _hyper(128, dropout=DROPOUT), seeds=(50, 51))
    _assert_same(states[True], states[False])
    assert replays == {False: (0, 0), True: (9, 1)}
    assert moved[True] == moved[False]
    assert offsets[True] == offsets[False] and offsets[True][0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_replayed_overlap_chunk_equals_eager_on_the_card(card,
                                                         compute_dtype):
    noisy, clean, starts, layers = _on_card(card, 16)
    hyper = _hyper(128, compute_dtype)
    states = {}
    before = _counts()
    for graph in (False, True):
        states[graph] = train_chunk_overlap(
            _state(layers, card), noisy, clean, starts, LR, hyper,
            graph=graph)
    torch.cuda.synchronize()
    assert _delta(before) == (10, 4, 1)
    assert states[True]._graph is not None and states[False]._graph is None
    _assert_same(states[True], states[False])


@pytest.mark.cuda
def test_replayed_overlap_chunk_equals_the_replayed_flat_one_on_the_card(
        card):
    """At ``mesh=None`` in float32 every operation of the overlapped step
    is one autograd runs for the flat step: both replayed, the same
    bits."""
    noisy, clean, starts, layers = _on_card(card, 17)
    hyper = _hyper(128)
    flat = train_chunk(_state(layers, card), noisy, clean, starts, LR, hyper)
    over = train_chunk_overlap(_state(layers, card), noisy, clean, starts,
                               LR, hyper)
    assert over._graph.key[0] == "overlap" and flat._graph.key[0] == "flat"
    _assert_same(over, flat)


@pytest.mark.cuda
def test_a_state_that_switches_steps_captures_anew_on_the_card(card):
    """flat, overlapped, flat on one state and the same tensors: a capture
    at each switch, bit for bit the same calls eager.  In bfloat16 the two
    steps round differently, so a replay of the other step's graph would
    show."""
    noisy, clean, starts, layers = _on_card(card, 18)
    hyper = _hyper(128, "bfloat16")
    graphed, eager = _state(layers, card), _state(layers, card)
    before = _counts()
    for fn in (train_chunk, train_chunk_overlap, train_chunk):
        fn(graphed, noisy, clean, starts, LR, hyper)
        fn(eager, noisy, clean, starts, LR, hyper, graph=False)
    torch.cuda.synchronize()
    assert _delta(before) == (30, 12, 3)
    _assert_same(graphed, eager)
    flat = _state(layers, card)
    for _ in range(3):
        train_chunk(flat, noisy, clean, starts, LR, hyper, graph=False)
    assert not torch.equal(flat.model.weights[0], graphed.model.weights[0])


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_one_nccl_rank_replays_the_eager_overlap_chunk(nccl_rank,
                                                       compute_dtype):
    """The per-layer all-reduces and their waits inside the graph: the
    eager overlapped loop's bits, launches and ``Mesh.traffic`` (the
    column sums and one all-reduce per layer, two in bfloat16)."""
    mesh = nccl_rank
    noisy, clean, starts, layers = _on_card(mesh.device, 19)
    states, moved, replays, _ = _nccl_chunks(
        mesh, train_chunk_overlap, layers, (noisy, clean), starts,
        _hyper(128, compute_dtype))
    _assert_same(states[True], states[False])
    assert replays == {False: (0, 0), True: (9, 1)}
    assert moved[True] == moved[False]
    bunches = 2 * starts.shape[0]
    per_layer = 1 if compute_dtype == "float32" else 2
    assert moved[True][:4] == [0, bunches, bunches, bunches]
    assert moved[True][4] == bunches * (1 + per_layer * len(layers))


class _Held:
    """A stand-in for a graph that holds a group's collectives."""

    def __init__(self):
        self.released = 0

    def release(self):
        self.released += 1


def test_shutdown_releases_the_live_graphs_first():
    """``shutdown_distributed`` (here with no group) releases each graph
    named to ``release_on_shutdown`` that still lives, once; a graph that
    is gone is not kept alive for it."""
    import gc
    import weakref

    from tpu_se_torch.parallel import distributed

    kept, dropped = _Held(), _Held()
    distributed.release_on_shutdown(kept)
    distributed.release_on_shutdown(dropped)
    gone = weakref.ref(dropped)
    del dropped
    gc.collect()
    assert gone() is None
    distributed.shutdown_distributed()
    assert kept.released == 1
    distributed.shutdown_distributed()
    assert kept.released == 1


def test_a_released_bunch_graph_is_not_replayed(monkeypatch):
    """``_BunchGraph.release`` destroys the graph after the card's work is
    done and clears its key, so the state's next chunk captures anew."""

    class _Graph:
        resets = 0

        def reset(self):
            self.resets += 1

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    stream = type("Stream", (), {"device": torch.device("cuda", 0)})()
    g = step._BunchGraph(("key",), (), _Graph(), stream, None, None, None,
                         (0,) * 4)
    g.release()
    assert (g.key, g.graph.resets, synced) == (None, 1,
                                               [torch.device("cuda", 0)])


def test_shutdown_releases_a_live_bunch_graph(monkeypatch):
    """A real ``_BunchGraph`` can be named to ``release_on_shutdown`` (it
    hashes by identity, as a weak set needs), and leaving the group
    destroys its graph once: NCCL waits in ``destroy_process_group`` while
    a graph holding the group's collectives lives."""
    from tpu_se_torch.parallel import distributed

    class _Graph:
        resets = 0

        def reset(self):
            self.resets += 1

    monkeypatch.setattr(torch.cuda, "synchronize", lambda device: None)
    stream = type("Stream", (), {"device": torch.device("cuda", 0)})()
    graphs = [step._BunchGraph(("key",), (), _Graph(), stream, None, None,
                               None, (0,) * 4) for _ in range(2)]
    for g in graphs:
        distributed.release_on_shutdown(g)
    distributed.shutdown_distributed()
    distributed.shutdown_distributed()
    assert [(g.key, g.graph.resets) for g in graphs] == [(None, 1)] * 2


# -- the CV pass ---------------------------------------------------------------

def cv_problem(root, seed=6):
    """A 24-sentence pfile pair (the port's writers) whose CV set,
    sentences 4-23, takes more than one ``CV_BATCH`` when resident ->
    (noisy, clean, norm) paths."""
    from tpu_se_torch.io import write_norm, write_pfile

    rng = np.random.default_rng(seed)
    noisy = [(rng.normal(size=(n, 257)) * 2 + 3).astype(np.float32)
             for n in rng.integers(200, 330, size=24)]
    clean = [(x * 0.8 + rng.normal(scale=0.3, size=x.shape)
              ).astype(np.float32) for x in noisy]
    paths = tuple(str(root / name) for name in
                  ("noisy.pfile", "clean.pfile", "noisy.norm"))
    write_pfile(paths[0], noisy)
    write_pfile(paths[1], clean)
    frames = np.concatenate(noisy)
    write_norm(paths[2], frames.mean(0), 1.0 / frames.std(0))
    return paths


def cv_turns(states: dict, ds, hyper, frames, device, turns: int = 2,
             mesh=None) -> tuple[list, list]:
    """``turns`` CV passes of each state of ``{graph: state}``, alpha (a new
    tensor) and the weights (in place) changed before each -> (per turn
    ``{graph: metrics}``, per turn ``{graph: (replays, captures,
    counters moved)}``)."""
    from tpu_se_torch.train.loop import evaluate_cv

    metrics, moved = [], []
    for turn in range(turns):
        metrics.append({})
        moved.append({})
        for graph, state in states.items():
            state.alpha = torch.linspace(0.6 + 0.1 * turn, 1.4, 257,
                                         device=device)
            with torch.no_grad():
                for layer in param_layers(state.model):
                    layer["w"].mul_(1.0 + 0.01 * turn)
            before = (step.cv_batches_replayed, step.cv_graphs_captured,
                      step.read_counts(None if mesh is None
                                       else mesh.traffic))
            metrics[turn][graph] = evaluate_cv(state, ds, hyper, device,
                                               frames, graph=graph)
            if device.type == "cuda":
                torch.cuda.synchronize()
            moved[turn][graph] = (
                step.cv_batches_replayed - before[0],
                step.cv_graphs_captured - before[1],
                [b - a for a, b in zip(before[2], step.read_counts(
                    None if mesh is None else mesh.traffic))])
    return metrics, moved


def test_cv_pass_replay_rule_and_key(tmp_path):
    """On the CPU the CV pass is eager whatever ``graph`` says, and keeps
    no graph; a CV graph's key follows the frames, the parameters and
    ``hyper``, not alpha."""
    from tpu_se_torch.data import PfilePairDataset

    ds = PfilePairDataset(*cv_problem(tmp_path), (4, 23), 1200)
    states = {g: _state(init_params(5, NARROW), "cpu") for g in (True, False)}
    metrics, moved = cv_turns(states, ds, TrainHyper(beta=0.9), None,
                              torch.device("cpu"))
    for turn in metrics:
        assert turn[True] == turn[False]
    assert metrics[0][True] != metrics[1][True]
    assert all(m == (0, 0, [0] * 4) for turn in moved for m in turn.values())
    assert states[True]._cv_graph is None
    assert not step.CVPass(states[True], TrainHyper(), "cpu").replays
    state = states[True]
    noisy, clean = torch.zeros(8, 257), torch.zeros(8, 257)
    hyper = TrainHyper()
    key = step._cv_key(state, noisy, clean, hyper, None)[0]
    state.alpha = torch.ones(257)
    assert step._cv_key(state, noisy, clean, hyper, None)[0] == key
    assert step._cv_key(state, noisy.clone(), clean, hyper, None)[0] != key
    assert step._cv_key(state, noisy, clean, TrainHyper(beta=0.9),
                        None)[0] != key
    other = _state(init_params(5, NARROW), "cpu")
    assert step._cv_key(other, noisy, clean, hyper, None)[0] != key


def test_a_cv_graph_releases_on_shutdown(monkeypatch):
    from tpu_se_torch.parallel import distributed

    class _Graph:
        resets = 0

        def reset(self):
            self.resets += 1

    monkeypatch.setattr(torch.cuda, "synchronize", lambda device: None)
    stream = type("Stream", (), {"device": torch.device("cuda", 0)})()
    g = step._CVGraph(("key",), (), _Graph(), stream, *([None] * 6))
    distributed.release_on_shutdown(g)
    distributed.shutdown_distributed()
    assert (g.key, g.graph.resets) == (None, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "per-chunk"])
def test_cv_replay_equals_eager_across_alpha_and_weights(card, tmp_path,
                                                         compute_dtype,
                                                         resident):
    """Two CV passes, alpha and the weights changed before each: the
    replayed sums bit for bit the eager pass's every time, one capture
    (after one eager batch), every other batch a replay."""
    from tpu_se_torch.data import PfilePairDataset
    from tpu_se_torch.train.loop import CV_BATCH, load_device_frames

    ds = PfilePairDataset(*cv_problem(tmp_path), (4, 23),
                          102400 if resident else 1200)
    frames = load_device_frames(ds, card) if resident else None
    batches = sum(-(-len(ds.chunk_starts(i)) // CV_BATCH)
                  for i in range(ds.n_chunks))
    assert batches > 1
    states = {g: _state(init_params(5, NARROW), card) for g in (True, False)}
    metrics, moved = cv_turns(
        states, ds, TrainHyper(beta=0.9, compute_dtype=compute_dtype),
        frames, card)
    for turn in metrics:
        assert turn[True] == turn[False]
    assert metrics[0][True] != metrics[1][True]
    assert [m[True][:2] for m in moved] == [(batches - 1, 1), (batches, 0)]
    assert [m[False][:2] for m in moved] == [(0, 0), (0, 0)]
    assert states[False]._cv_graph is None
    assert states[True]._cv_graph.owns_frames is not resident
