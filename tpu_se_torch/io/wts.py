""".wts weight files, byte-compatible with the reference trainer.

Copy of ``tpu_se/io/wts.py``.  Per layer a weights then a bias record, each
``int32[5] {10, rows, cols, 0, len(name)+1}``, the NUL-terminated name,
then float32 row-major data, little-endian (``Interface.cc:429-516``).
Weight records store ``[n_out, n_in]``; in memory a layer is ``{"w":
[n_in, n_out], "b": [n_out]}``, so ``w`` is transposed on read and write.
"""

from __future__ import annotations

import struct

import numpy as np

from tpu_se_torch.io.atomic import atomic_write


def read_wts(path) -> list[dict]:
    """Read a .wts file -> [{'w': [n_in, n_out] f32, 'b': [n_out] f32}, ...]."""
    layers = []
    with open(path, "rb") as f:
        while True:
            stat = f.read(20)
            if len(stat) < 20:
                break
            magic, rows, cols, _zero, name_len = struct.unpack("<5i", stat)
            if magic != 10:
                raise ValueError(f"bad .wts record magic {magic}")
            name = f.read(name_len).split(b"\0")[0].decode("ascii")
            data = np.frombuffer(f.read(rows * cols * 4), dtype="<f4")
            data = data.reshape(rows, cols)
            if name.startswith("weights"):
                layers.append({"w": data.T.astype(np.float32).copy()})
            elif name.startswith("bias"):
                if not layers or "b" in layers[-1]:
                    raise ValueError(f"unexpected bias record {name}")
                layers[-1]["b"] = data.reshape(-1).astype(np.float32).copy()
            else:
                raise ValueError(f"unknown .wts record {name!r}")
    for i, layer in enumerate(layers):
        if "b" not in layer:
            raise ValueError(f"layer {i} missing bias record")
    return layers


def write_wts(path, layers: list[dict]) -> None:
    """Write [{'w': [n_in, n_out], 'b': [n_out]}, ...] in the reference
    layout, atomically."""
    def records(f):
        for i, layer in enumerate(layers):
            w = np.asarray(layer["w"], dtype=np.float32)
            b = np.asarray(layer["b"], dtype=np.float32).reshape(-1)
            n_in, n_out = w.shape
            if b.shape[0] != n_out:
                raise ValueError(f"layer {i}: bias/weight shape mismatch")
            _write_record(f, f"weights{i + 1}{i + 2}", w.T)
            _write_record(f, f"bias{i + 2}", b.reshape(1, n_out))

    atomic_write(path, records)


def _write_record(f, name: str, data: np.ndarray) -> None:
    name_b = name.encode("ascii") + b"\0"
    rows, cols = data.shape
    f.write(struct.pack("<5i", 10, rows, cols, 0, len(name_b)))
    f.write(name_b)
    f.write(np.ascontiguousarray(data, dtype="<f4").tobytes())
