"""Guards for the port: no JAX, no silent CPU fallback, import hygiene."""

import pathlib
import subprocess
import sys

import pytest
import torch

import test_lint
from tpu_se_torch.utils import resolve_device

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
            "import tpu_se_torch.io.atomic, tpu_se_torch.io.wav\n"
            "import tpu_se_torch.io.htk, tpu_se_torch.io.pfile\n"
            "import tpu_se_torch.io.norm, tpu_se_torch.io.wts\n"
            "import tpu_se_torch.io.readahead\n"
            "import tpu_se_torch.train, tpu_se_torch.data\n"
            "import tpu_se_torch.losses, tpu_se_torch.utils.logging\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'tpu_se'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_resolve_device_cpu_pins_fp32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert resolve_device("cpu") == torch.device("cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


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
