"""Seeded weights of a configuration, made on the device in a few calls.

The benchmark makes the weights, hands the same dict to the program
(``load_state_dict`` by name) and to the reference, so the reference
takes nothing the program made. One normal and one uniform draw of the
whole model's size come from a generator on the device seeded from
``seed``; each tensor is a scaled slice of one of them, by the rule that
``reference.model.param_spec`` gives it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws of run ``seed`` (any whole
    number, larger than 32 bits included)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *stream]).generate_state(1, np.uint64)
    return int(state[0]) & 0x7FFF_FFFF_FFFF_FFFF


def make_weights(spec: list, seed: int, device) -> dict:
    """``{name: tensor}`` for ``[(name, shape, rule)]`` from ``seed``."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out = {}
    start = 0
    weight_shape = None  # a bias takes the fan-in of the weight before it
    for (name, shape, rule), n in zip(spec, sizes):
        sl = slice(start, start + n)
        start += n
        if rule == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        if rule in ("ones", "zeros"):
            out[name] = (torch.ones if rule == "ones" else torch.zeros)(shape, device=device)
            continue
        if rule == "kaiming":
            cout, _, kh, kw = shape
            t = normal[sl] * math.sqrt(2.0 / (cout * kh * kw))
        elif rule == "uniform":
            t = uniform[sl] / math.sqrt(math.prod(shape[1:]))
        elif rule == "bias":
            t = uniform[sl] / math.sqrt(math.prod(weight_shape[1:]))
        elif rule == "nconv":
            cout, _, k, _ = shape
            t = F.softplus(10.0 * (2.0 + math.sqrt(2.0 / (k * k * cout)) * normal[sl])) / 10.0
        else:
            raise ValueError(f"unknown init rule {rule!r} for {name}")
        out[name] = t.reshape(shape).clone()
        if rule != "bias":
            weight_shape = shape
    return out
