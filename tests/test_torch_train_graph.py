"""``train_chunk``'s captured bunch (``graph=True``, the default) against
its eager loop (``graph=False``) and against ``tpu_se.train``.

On the CPU there are no graphs: ``graph=True`` runs the eager loop, so the
two flags give the same bits, the counters of replays, captures and GGD
kernel launches stay where they were, and no graph is kept on the state.
The rule that picks the replay (a card, no mesh, no dropout masks) is
checked on device descriptors.  The default call is held to
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
replays = bunches - warm-ups, one warm-up per capture.  Run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_graph.py
"""

import numpy as np
import pytest
import torch

from tpu_se_torch.models import init_params, params_from_numpy
from tpu_se_torch.ops import ggd_kernel
from tpu_se_torch.train import TrainHyper, make_train_state, param_layers
from tpu_se_torch.train import step
from tpu_se_torch.train.step import train_chunk

NARROW = (1799, 64, 64, 257)
LR = 0.1


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


def _hyper(m, compute_dtype="float32"):
    return TrainHyper(beta=1.0, ml=True, bunchsize=m, context=7,
                      targ_offset=3, grad_scale="parity",
                      compute_dtype=compute_dtype)


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


@pytest.mark.parametrize("device,mesh,dropout,want", [
    ("cuda", None, None, True),
    ("cuda:1", None, None, True),
    ("cpu", None, None, False),
    ("cuda", "mesh", None, False),
    ("cuda", None, (0.1, 0.2), False),
    ("cpu", "mesh", (0.1, 0.2), False),
])
def test_replay_rule(device, mesh, dropout, want):
    assert step._replays(torch.device(device), mesh, dropout) is want


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
