"""Model weights from the run's seed, made on the device in one draw.

The reference's ``spec(cfg)`` lists every tensor by the program's
state_dict name with its shape and initialiser. One normal draw from a
``torch.Generator`` seeded with the run's seed, on the run's device,
fills every random tensor: ``dense`` tensors scaled by 1/sqrt(fan-in)
(fan-in: the product of every axis but the first), ``normal`` ones as
drawn; constants are filled. The same seed on the same device gives the
same weights, so the reference re-makes them after the program's state is
freed instead of keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SEED_SALT = 0x5EED  # keeps the weight stream apart from the traffic's


def make(spec: List[Tuple[str, tuple, str]], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) ^ SEED_SALT) % (2 ** 63))
    drawn = [(n, s, i) for n, s, i in spec if i in ("dense", "normal")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, init in drawn:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        if init == "dense":
            t = t * (1.0 / math.sqrt(math.prod(shape[1:])))
        out[name] = t
        at += n
    for name, shape, init in spec:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init not in ("dense", "normal"):
            raise ValueError(f"unknown initialiser {init!r} for {name}")
    return {name: out[name] for name, _, _ in spec}
