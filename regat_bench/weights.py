"""The parameters of a run, made from its seed on the device: one uniform
draw for all leaves (one torch.Generator, one call), cut and scaled leaf by
leaf to reference/params.py's ranges; each weight norm's g is the norm of
its v. Both the program and the reference are handed these tensors."""

from __future__ import annotations

from typing import Dict

import torch

from regat_bench.reference.params import param_spec


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = param_spec(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, kind, _ in spec if kind == "uniform"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 7919)
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2.0).sub_(1.0)
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    for name, shape, kind, bound in spec:
        if kind == "uniform":
            n = int(torch.Size(shape).numel())
            out[name] = flat[pos:pos + n].view(shape).mul(bound)
            pos += n
    for name, shape, kind, _ in spec:
        if kind == "norm":
            out[name] = torch.linalg.vector_norm(out[name[:-2] + ".v"]).reshape(shape)
    return {name: out[name] for name, *_ in spec}
