"""The momentum-SGD update: ``train.optim.sgd_momentum_update``'s routes,
the fused kernel's wrapper (``ops/sgd_kernel.py``) and its argument checks.

On the CPU the update is the plain eager operations and never loads the
kernel library.  What the CPU can hold of the kernel is held here:

- its operation order, emulated in numpy float32 one rounding at a time
  (``_kernel_model``), equals ``sgd_update_plain`` bit for bit at n = 1
  and n = 128, where the card's reciprocal and the CPU's division are the
  same function; the cases include a bias with a -0.0 step and velocity
  and an inf weight, where a decay of 0 * p would change bits, and a
  257-long bias.  At n = 3 the CPU's division and the card's reciprocal
  differ, which is why the kernel follows the card;
- ``check_sgd_args`` raises on each argument the kernel does not take
  (meta tensors stand in for a second device and for a length past
  int32);
- every training caller hands the update contiguous float32 tensors
  (``train_chunk`` in float32 and bfloat16, ``train_chunk_overlap``);
- the table entry's layout and the table's size are the C source's.

On a card (tests marked ``cuda``) every comparison is bit for bit against
``sgd_update_plain``'s eager operations there: full-width shapes at n in
{1, 3, 100, 128}, the rate as a float and as a 0-dim tensor, weight cost
0 and 1e-5; views at unaligned offsets of one flat buffer; a captured
``torch.cuda.CUDAGraph`` replayed at two rates; a list longer than one
table; ``train_chunk`` (float32 and bfloat16, replayed and eager) and
``train_chunk_overlap`` at ``mesh=None`` against the same calls with the
plain update.  Launches = update calls throughout.  Run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_optim.py
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from tpu_se_torch.models import init_params, params_from_numpy
from tpu_se_torch.models.ffn import DEFAULT_LAYERSIZES
from tpu_se_torch.ops import _build, sgd_kernel
from tpu_se_torch.ops.sgd_kernel import (
    check_sgd_args, sgd_update_cuda, sgd_update_plain,
)
from tpu_se_torch.parallel import overlap_step
from tpu_se_torch.parallel.overlap_step import train_chunk_overlap
from tpu_se_torch.train import TrainHyper, make_train_state, optim, step
from tpu_se_torch.train.optim import sgd_momentum_update
from tpu_se_torch.train.step import train_chunk

MOMENTUM = 0.9
LR = 0.1
NARROW = (1799, 64, 257)


def _lists(rng, layersizes, device="cpu", special=False):
    """Seeded (params, velocity, grads) as ``[{"w", "b"}]`` float32
    tensors.  ``special``: the last bias has a -0.0 gradient and velocity
    in its first elements and an inf weight after them."""
    out = []
    for _ in range(3):
        layers = []
        for n_in, n_out in zip(layersizes[:-1], layersizes[1:]):
            layers.append({
                "w": rng.standard_normal((n_in, n_out)).astype(np.float32),
                "b": rng.standard_normal(n_out).astype(np.float32)})
        out.append(layers)
    params, velocity, grads = out
    if special:
        velocity[-1]["b"][:8] = -0.0
        grads[-1]["b"][:8] = -0.0
        params[-1]["b"][8] = np.inf
    return [[{k: torch.from_numpy(v.copy()).to(device)
              for k, v in layer.items()} for layer in x] for x in out]


def _copy(lists):
    return [[{k: v.clone() for k, v in layer.items()} for layer in x]
            for x in lists]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def _assert_same(a, b):
    """Bitwise, -0.0 against +0.0 and inf included."""
    for x, y in zip(a, b):
        for lx, ly in zip(x, y):
            for k in ("w", "b"):
                np.testing.assert_array_equal(_bits(lx[k]), _bits(ly[k]),
                                              err_msg=k)


def _kernel_model(p, v, g, lr, momentum, wc, n, decay_always=False):
    """csrc/sgd_kernel.cu's arithmetic in numpy float32, one rounding per
    operation, in its order -> (p, v).  ``decay_always`` adds wc * p at
    wc == 0 too (what the kernel must not do)."""
    f32 = np.float32
    s = g * (f32(1) / f32(n))
    if wc or decay_always:
        s = s + f32(wc) * p
    v = f32(momentum) * v - f32(lr) * s
    return p + v, v


def _model_update(lists, lr, wc, n, **kw):
    """``_kernel_model`` over every tensor -> new numpy (params, velocity)."""
    params, velocity, grads = ([{k: t.numpy().copy() for k, t in l.items()}
                                for l in x] for x in lists)
    for p_l, v_l, g_l in zip(params, velocity, grads):
        for key, w in (("w", wc), ("b", 0.0)):
            p_l[key], v_l[key] = _kernel_model(p_l[key], v_l[key], g_l[key],
                                               lr, MOMENTUM, w, n, **kw)
    return params, velocity


def _same_as_model(lists, model) -> bool:
    return all(np.array_equal(t.numpy().view(np.uint32), m.view(np.uint32))
               for x, y in zip(lists[:2], model)
               for l, ml in zip(x, y) for k, t in l.items()
               for m in (ml[k],))


# -- on the CPU ----------------------------------------------------------------

def test_cpu_update_is_the_plain_ops_without_the_library(monkeypatch):
    def refuse():
        raise AssertionError("the CPU route loaded the kernel library")

    monkeypatch.setattr(_build, "load_library", refuse)
    calls = []
    monkeypatch.setattr(optim, "sgd_update_plain",
                        lambda *a: calls.append(a) or sgd_update_plain(*a))
    lists = _lists(np.random.default_rng(0), NARROW)
    want = _copy(lists)
    before = sgd_kernel.launches
    sgd_momentum_update(*lists, LR, MOMENTUM, 1e-5, 128)
    sgd_update_plain(*want, LR, MOMENTUM, 1e-5, 128)
    assert len(calls) == 1 and sgd_kernel.launches == before
    _assert_same(lists, want)


@pytest.mark.parametrize("n", [1, 128])
@pytest.mark.parametrize("wc", [0.0, 1e-5])
@pytest.mark.parametrize("tensor_lr", [False, True])
def test_kernel_order_equals_plain_on_the_cpu(n, wc, tensor_lr):
    lists = _lists(np.random.default_rng(n), (31, 16, 257), special=True)
    model = _model_update(lists, LR, wc, n)
    lr = torch.tensor(LR, dtype=torch.float32) if tensor_lr else LR
    sgd_update_plain(*lists, lr, MOMENTUM, wc, n)
    assert _same_as_model(lists, model)


@pytest.mark.parametrize("n", [1, 128])
def test_a_zero_decay_would_change_bits(n):
    """The special values make the test able to fail: adding 0 * p to a
    bias's step flips the sign of zero velocities and turns the inf weight
    to NaN."""
    lists = _lists(np.random.default_rng(n + 1), (31, 16, 257), special=True)
    with np.errstate(invalid="ignore"):
        wrong = _model_update(lists, LR, 1e-5, n, decay_always=True)
    sgd_update_plain(*lists, LR, MOMENTUM, 1e-5, n)
    assert not _same_as_model(lists, wrong)
    assert torch.isinf(lists[0][-1]["b"][8]) and np.isnan(wrong[0][-1]["b"][8])
    assert (_bits(lists[1][-1]["b"][:8])
            != wrong[1][-1]["b"][:8].view(np.uint32)).any()


def test_cpu_division_differs_from_the_card_reciprocal_at_n_3():
    lists = _lists(np.random.default_rng(3), (31, 16, 257))
    model = _model_update(lists, LR, 1e-5, 3)
    sgd_update_plain(*lists, LR, MOMENTUM, 1e-5, 3)
    assert not _same_as_model(lists, model)


def _bad(case):
    """(params, velocity, grads, lr) on the CPU with one fault."""
    lists = _lists(np.random.default_rng(4), (5, 4, 3))
    p, v, g = lists
    lr = LR
    if case == "mixed device":
        v[1]["w"] = torch.empty(4, 3, device="meta")
    elif case == "float64":
        g[0]["b"] = g[0]["b"].double()
    elif case == "bfloat16":
        p[0]["w"] = p[0]["w"].bfloat16()
    elif case == "shape":
        g[1]["w"] = torch.zeros(3, 4)
    elif case == "non-contiguous":
        p[0]["w"] = torch.zeros(4, 5).t()
    elif case == "int32 length":
        for x in lists:
            for layer in x:
                for k in layer:
                    layer[k] = layer[k].to("meta")
            x[0]["b"] = torch.empty(2**31, device="meta")
    elif case == "lr float64":
        lr = torch.tensor(LR, dtype=torch.float64)
    elif case == "lr shape":
        lr = torch.tensor([LR], dtype=torch.float32)
    elif case == "lr device":
        lr = torch.tensor(LR, dtype=torch.float32, device="meta")
    elif case == "layers":
        del v[1]
    elif case == "keys":
        del g[0]["b"]
    return p, v, g, lr


@pytest.mark.parametrize("case,match", [
    ("mixed device", "on meta"),
    ("float64", "must be float32"),
    ("bfloat16", "must be float32"),
    ("shape", "differ in shape"),
    ("non-contiguous", "contiguous"),
    ("int32 length", "int32"),
    ("lr float64", "0-dim float32"),
    ("lr shape", "0-dim float32"),
    ("lr device", "lr on meta"),
    ("layers", "1 velocity"),
    ("keys", "not w and b"),
])
def test_check_sgd_args_raises(case, match):
    with pytest.raises(ValueError, match=f"sgd_update_cuda: .*{match}"):
        check_sgd_args(*_bad(case))


@pytest.mark.parametrize("tensor_lr", [False, True])
def test_check_sgd_args_takes_good_args(tensor_lr):
    lists = _lists(np.random.default_rng(5), NARROW)
    check_sgd_args(*lists, torch.tensor(LR) if tensor_lr else LR)
    check_sgd_args([], [], [], LR)


def test_cuda_wrapper_refuses_cpu_tensors_without_loading(monkeypatch):
    def refuse():
        raise AssertionError("loaded the kernel library")

    monkeypatch.setattr(_build, "load_library", refuse)
    lists = _lists(np.random.default_rng(6), (5, 4, 3))
    before = sgd_kernel.launches
    with pytest.raises(ValueError, match="sgd_update_cuda: .*CUDA tensors"):
        sgd_update_cuda(*lists, LR, MOMENTUM, 1e-5, 128)
    assert sgd_kernel.launches == before


def test_entry_layout_is_the_c_sources():
    src = (pathlib.Path(sgd_kernel.__file__).parent.parent / "csrc"
           / "sgd_kernel.cu").read_text()
    assert re.search(rf"kMaxTensors = {sgd_kernel.MAX_TENSORS};", src)
    fields = re.search(r"struct SgdEntry \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+);", fields)
    assert names == [f[0] for f in sgd_kernel._Entry._fields_]
    assert ctypes.sizeof(sgd_kernel._Entry) == 40
    assert [getattr(sgd_kernel._Entry, f).offset for f in names] == [
        0, 8, 16, 24, 28, 32]


def _problem(seed, m, n_bunches, layersizes=NARROW, n_frames=512):
    rng = np.random.default_rng(seed)
    noisy = rng.normal(size=(n_frames, 257)).astype(np.float32)
    clean = (0.8 * noisy + rng.normal(scale=0.1, size=noisy.shape)
             ).astype(np.float32)
    starts = rng.integers(0, n_frames - 7, size=(n_bunches, m))
    return (noisy, clean, starts.astype(np.int64),
            init_params(seed + 1, layersizes))


@pytest.mark.parametrize("route", ["float32", "bfloat16", "overlap"])
def test_every_training_caller_hands_the_kernel_what_it_takes(monkeypatch,
                                                              route):
    """On the CPU the update runs plain, but each call's arguments must
    already pass the kernel's checks: contiguous float32 of one device."""
    calls = []

    def checked(*args):
        check_sgd_args(*args[:4])
        calls.append(args[-1])
        sgd_momentum_update(*args)

    module = overlap_step if route == "overlap" else step
    monkeypatch.setattr(module, "sgd_momentum_update", checked)
    noisy, clean, starts, layers = _problem(7, 16, 2)
    hyper = TrainHyper(bunchsize=16, compute_dtype=(
        "bfloat16" if route == "bfloat16" else "float32"))
    run = train_chunk_overlap if route == "overlap" else train_chunk
    before = sgd_kernel.launches
    run(make_train_state(params_from_numpy(layers, "cpu")),
        torch.from_numpy(noisy), torch.from_numpy(clean),
        torch.from_numpy(starts), LR, hyper)
    assert calls == [16, 16] and sgd_kernel.launches == before


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_and_plain(lists, lr, wc, n):
    """The kernel on ``lists`` and the plain ops on a copy, one call each
    -> (kernel's lists, plain's lists, launches of the call)."""
    plain = _copy(lists)
    before = sgd_kernel.launches
    sgd_momentum_update(*lists, lr, MOMENTUM, wc, n)
    launched = sgd_kernel.launches - before
    sgd_update_plain(*plain, lr, MOMENTUM, wc, n)
    torch.cuda.synchronize()
    return lists, plain, launched


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 100, 128])
@pytest.mark.parametrize("wc", [0.0, 1e-5])
@pytest.mark.parametrize("tensor_lr", [False, True])
def test_kernel_equals_plain_on_the_card(card, n, wc, tensor_lr):
    lists = _lists(np.random.default_rng(n), DEFAULT_LAYERSIZES, card,
                   special=True)
    lr = (torch.tensor(LR, dtype=torch.float32, device=card) if tensor_lr
          else LR)
    got, want, launched = _kernel_and_plain(lists, lr, wc, n)
    assert launched == 1
    _assert_same(got, want)


@pytest.mark.cuda
def test_card_division_is_the_reciprocal(card):
    """The premise of the kernel's rounding: on the card ``g / n`` by a
    host scalar is ``g * (1/n)`` with the reciprocal rounded to float32."""
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        1 << 16).astype(np.float32)).to(card)
    for n in (3, 100):
        inv = float(np.float32(1) / np.float32(n))
        assert torch.equal((g / n).view(torch.int32),
                           (g * inv).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_on_unaligned_views(card, offset):
    """Views into one flat buffer, as ``Mesh.all_reduce_sum_flat`` returns
    them, at offsets that are not multiples of 4 floats."""
    sizes = (1799, 63, 257)
    lists = _lists(np.random.default_rng(offset), sizes, card)
    views = []
    for x in lists:
        flat = torch.empty(offset + sum(t.numel() for l in x
                                        for t in l.values()), device=card)
        lo, out = offset, []
        for layer in x:
            out.append({})
            for k, t in layer.items():
                out[-1][k] = flat[lo:lo + t.numel()].view(t.shape)
                out[-1][k].copy_(t)
                lo += t.numel()
        views.append(out)
    got, want, launched = _kernel_and_plain(views, LR, 1e-5, 128)
    assert launched == 1
    _assert_same(got, want)


@pytest.mark.cuda
def test_kernel_in_a_captured_graph_at_two_rates(card):
    lists = _lists(np.random.default_rng(9), DEFAULT_LAYERSIZES, card)
    plain = _copy(lists)
    rate = torch.empty((), dtype=torch.float32, device=card)
    rate.fill_(LR)
    sgd_update_cuda(*lists, rate, MOMENTUM, 1e-5, 128)   # warm-up, eager
    sgd_update_plain(*plain, LR, MOMENTUM, 1e-5, 128)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        before = sgd_kernel.launches
        graph.capture_begin()
        try:
            sgd_update_cuda(*lists, rate, MOMENTUM, 1e-5, 128)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    assert sgd_kernel.launches - before == 1
    torch.cuda.synchronize()
    _assert_same(lists, plain)       # the capture ran nothing
    for lr in (LR, 0.05, 0.05):
        rate.fill_(lr)
        graph.replay()
        sgd_update_plain(*plain, lr, MOMENTUM, 1e-5, 128)
    torch.cuda.synchronize()
    _assert_same(lists, plain)


@pytest.mark.cuda
def test_a_long_list_takes_one_launch_per_table(card):
    layersizes = tuple(range(3, 3 + sgd_kernel.MAX_TENSORS + 5))
    lists = _lists(np.random.default_rng(10), layersizes, card)
    got, want, launched = _kernel_and_plain(lists, LR, 1e-5, 1)
    assert 2 * (len(layersizes) - 1) > sgd_kernel.MAX_TENSORS
    assert launched == -(-2 * (len(layersizes) - 1) // sgd_kernel.MAX_TENSORS)
    _assert_same(got, want)


def _card_states(card, layers):
    return [make_train_state(params_from_numpy(layers, card))
            for _ in range(2)]


def _assert_same_states(a, b):
    """Weights, velocity and alpha of two training states, bitwise."""
    _assert_same(*([[{"w": w.detach(), "b": b.detach()}
                     for w, b in zip(s.model.weights, s.model.biases)],
                    s.velocity] for s in (a, b)))
    assert torch.equal(a.alpha, b.alpha)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("graph", [True, False])
def test_train_chunk_with_the_kernel_equals_plain(card, monkeypatch,
                                                  compute_dtype, graph):
    noisy, clean, starts, layers = _problem(11, 128, 5, (1799, 64, 64, 257),
                                            1024)
    args = [torch.from_numpy(a).to(card) for a in (noisy, clean, starts)]
    hyper = TrainHyper(bunchsize=128, compute_dtype=compute_dtype)
    fused, plain = _card_states(card, layers)
    before = sgd_kernel.launches
    train_chunk(fused, *args, LR, hyper, graph=graph)
    assert sgd_kernel.launches - before == 5      # one per bunch
    monkeypatch.setattr(step, "sgd_momentum_update", sgd_update_plain)
    train_chunk(plain, *args, LR, hyper, graph=graph)
    torch.cuda.synchronize()
    assert sgd_kernel.launches - before == 5
    _assert_same_states(fused, plain)


@pytest.mark.cuda
def test_overlap_step_with_the_kernel_equals_plain(card, monkeypatch):
    noisy, clean, starts, layers = _problem(12, 128, 5, (1799, 64, 64, 257),
                                            1024)
    args = [torch.from_numpy(a).to(card) for a in (noisy, clean, starts)]
    hyper = TrainHyper(bunchsize=128)
    fused, plain = _card_states(card, layers)
    before = sgd_kernel.launches
    train_chunk_overlap(fused, *args, LR, hyper)
    assert sgd_kernel.launches - before == 5
    monkeypatch.setattr(overlap_step, "sgd_momentum_update", sgd_update_plain)
    train_chunk_overlap(plain, *args, LR, hyper)
    torch.cuda.synchronize()
    _assert_same_states(fused, plain)
