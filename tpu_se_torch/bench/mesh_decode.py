"""Decode a set of waves and streams as one rank of a data mesh.

    python -m tpu_se_torch.bench.mesh_decode --wts W --norm N \\
        --problem P.npz --out DIR [--coordinator HOST:PORT \\
        --num-processes P --process-id K [--cpu-collectives gloo]] \\
        [--device cuda|cpu]

Run once per rank, like ``python -m tpu_se_torch train``; without
``--coordinator`` it is the one-process decode.  ``P.npz`` holds int16
``waves`` (concatenated, with their ``lengths``) and int16 ``hops`` [S, K,
shift].  Each rank decodes them in every form ``decode_all`` names, writes
what it got to ``DIR/mesh_decode.<rank>.npz`` and prints one JSON line: the
rank, the mesh, the LPS kernel's launches and the streaming step's graph
replays.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from tpu_se_torch.infer import Enhancer, StreamingEnhancer, streaming
from tpu_se_torch.ops import lps_kernel
from tpu_se_torch.parallel import (
    initialize_distributed, make_mesh, shutdown_distributed,
)
from tpu_se_torch.utils import resolve_device


def decode_all(wts: str, norm: str, problem: dict, mesh, device) -> dict:
    """The waves of ``problem`` through ``Enhancer(mesh=)`` -- ``enhance``
    plain and with ``blend="auto"``, ``enhance_batch``,
    ``enhance_batch_waves`` -- and its hops through
    ``StreamingEnhancer(mesh=).push_many(int16_wire=True)`` -> numpy
    arrays by name (``<form>_wave<i>``, ``<form>_lps<i>``, ``stream``,
    ``stream_valid``)."""
    waves = np.split(problem["waves"], np.cumsum(problem["lengths"])[:-1])
    out = {}
    plain = Enhancer(wts, norm, device=device, mesh=mesh)
    auto = Enhancer(wts, norm, device=device, blend="auto", mesh=mesh)
    forms = (("plain", [plain.enhance(w) for w in waves]),
             ("auto", [auto.enhance(w) for w in waves]),
             ("batch", plain.enhance_batch(waves)),
             ("fast", [(w, None, None)
                       for w in plain.enhance_batch_waves(waves)]))
    for form, got in forms:
        for i, (wave, _, lps) in enumerate(got):
            out[f"{form}_wave{i}"] = wave
            if lps is not None:
                out[f"{form}_lps{i}"] = lps
    hops = problem["hops"]
    streamer = StreamingEnhancer(wts, norm, n_streams=hops.shape[0],
                                 device=device, mesh=mesh)
    out["stream"], out["stream_valid"] = streamer.push_many(
        hops, int16_wire=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_se_torch.bench.mesh_decode",
                                description=__doc__.splitlines()[0])
    p.add_argument("--wts", required=True)
    p.add_argument("--norm", required=True)
    p.add_argument("--problem", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--coordinator", default="")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--cpu-collectives", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    with np.load(args.problem) as z:
        problem = dict(z)
    mesh = None
    if args.coordinator:
        info = initialize_distributed(args.coordinator, args.num_processes,
                                      args.process_id,
                                      args.cpu_collectives or None,
                                      args.device)
        mesh = make_mesh(device=info["device"])
    try:
        device = mesh.device if mesh is not None else resolve_device(
            args.device)
        got = decode_all(args.wts, args.norm, problem, mesh, device)
    finally:
        shutdown_distributed()
    rank = 0 if mesh is None else mesh.rank
    np.savez(os.path.join(args.out, f"mesh_decode.{rank}.npz"), **got)
    print(json.dumps({"rank": rank, "ranks": 1 if mesh is None else mesh.size,
                      "backend": None if mesh is None else mesh.backend,
                      "device": str(device),
                      "lps_launches": lps_kernel.launches,
                      "hops_replayed": streaming.hops_replayed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
