"""Guards for the port: no JAX, no silent CPU fallback, import hygiene."""

import pathlib
import subprocess
import sys

import pytest
import torch

import test_lint
from tpu_se_torch.utils import resolve_compute_dtype, resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_MODULES = sorted((ROOT / "tpu_se_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import tpu_se_torch, tpu_se_torch.infer, tpu_se_torch.cli.main\n"
            "import tpu_se_torch.dsp, tpu_se_torch.models, tpu_se_torch.ops\n"
            "import tpu_se_torch.io, tpu_se_torch.bench.profile_decode\n"
            "import tpu_se_torch.cli.bptrain, tpu_se_torch.infer.evaluate\n"
            "import tpu_se_torch.infer.stoi, tpu_se_torch.infer.pesq\n"
            "import tpu_se_torch.infer.streaming\n"
            "import tpu_se_torch.io.atomic, tpu_se_torch.io.wav\n"
            "import tpu_se_torch.io.htk, tpu_se_torch.io.pfile\n"
            "import tpu_se_torch.io.norm, tpu_se_torch.io.wts\n"
            "import tpu_se_torch.io.readahead\n"
            "import tpu_se_torch.train, tpu_se_torch.data\n"
            "import tpu_se_torch.losses, tpu_se_torch.utils.logging\n"
            "import tpu_se_torch.utils.profiling, tpu_se_torch.utils.device\n"
            "import tpu_se_torch.parallel, tpu_se_torch.parallel.mesh\n"
            "import tpu_se_torch.parallel.distributed, tpu_se_torch.__main__\n"
            "import tpu_se_torch.parallel.tensor\n"
            "import tpu_se_torch.bench.dp_epoch, tpu_se_torch.bench.mesh_decode\n"
            "import tpu_se_torch.data.pipeline\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'tpu_se'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_infer_exports_every_name_of_the_jax_package():
    import tpu_se.infer
    import tpu_se_torch.infer

    assert set(tpu_se.infer.__all__) <= set(tpu_se_torch.infer.__all__)
    for name in tpu_se_torch.infer.__all__:
        assert callable(getattr(tpu_se_torch.infer, name)), name


def test_parallel_exports_the_ported_names():
    import tpu_se.parallel
    import tpu_se_torch.parallel as port

    # Everything of the reference but its single-process device placement
    # (NamedShardings of one array over local devices), which the port's
    # process model has no use for: one process per device.  The model
    # axis' layout, param_shardings, is ported (with shard_params and
    # gather_params, which place and gather it).
    left_out = {"batch_sharding", "replicated_sharding"}
    assert set(tpu_se.parallel.__all__) - left_out <= set(port.__all__)
    assert {"Mesh", "shutdown_distributed", "allgather_host_rows",
            "allgather_rows", "sync_processes", "launch_local_ranks",
            "TensorParallelFFN", "shard_params",
            "gather_params"} <= set(port.__all__)
    assert len(set(port.__all__)) == len(port.__all__)
    for name in port.__all__:
        assert callable(getattr(port, name)), name
    import tpu_se_torch.data

    assert "shard_for_host" in tpu_se_torch.data.__all__


@pytest.mark.parametrize("package", ["dsp", "utils"])
def test_package_exports_every_name_of_the_jax_package(package):
    import importlib

    ref = importlib.import_module(f"tpu_se.{package}")
    port = importlib.import_module(f"tpu_se_torch.{package}")
    assert set(ref.__all__) <= set(port.__all__)
    assert len(set(port.__all__)) == len(port.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name
    new = {"dsp": ["NUM_CHANNELS", "NUM_CEP_COEFF", "MEL_START_FREQ",
                   "mel_filterbank", "dct_matrix", "mfcc_from_frames",
                   "wav_to_mfcc", "lps_to_wav"],
           "utils": ["profile_trace", "StepTimer", "get_logger",
                     "resolve_compute_dtype"]}[package]
    assert set(new) <= set(port.__all__)


def test_resolve_device_cpu_pins_fp32():
    matmul = torch.backends.cuda.matmul
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        assert resolve_device("cpu") == torch.device("cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert matmul.allow_bf16_reduced_precision_reduction is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        matmul.allow_bf16_reduced_precision_reduction = reduced


@pytest.mark.parametrize("given,want", [
    ("float32", torch.float32), ("bfloat16", torch.bfloat16),
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)],
    ids=str)
def test_resolve_compute_dtype(given, want):
    assert resolve_compute_dtype(given) is want


@pytest.mark.parametrize("bad", ["float16", torch.float16, torch.float64,
                                 "bf16", None, 32], ids=str)
def test_resolve_compute_dtype_rejects_other_types(bad):
    with pytest.raises(ValueError, match="unsupported compute dtype"):
        resolve_compute_dtype(bad)


@pytest.mark.parametrize("name", ["cuda", "cuda:0"])
def test_resolve_device_cuda_raises_without_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device(name)


def test_resolve_device_rejects_other_backends():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


@pytest.mark.parametrize("path", PORT_MODULES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_no_unused_imports(path):
    test_lint.test_no_unused_imports(path)
