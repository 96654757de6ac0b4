"""Initialisers, dropout, the per-step generator and the compute dtypes
(counterpart of tf_vqa_regat_tpu/nn.py).

Initialisers follow Keras' defaults, as the JAX package's do, and draw from an
explicit `torch.Generator` on the CPU, so one seed gives one model on every
machine. Dropout draws its bits on the tensor's device from the step's
generator (`step_generator` seeded with `step_seed`, the counterpart of
`RngGen` over `fold_in(base_rng, step)`), so a step's masks depend only on
the seed, the step and the order of the draws. The numbers differ from JAX's for the same
seed (another PRNG): tests carry parameters across with `params.py`, and
check masks by placement and keep rate.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from tf_vqa_regat_tpu_torch.ops.kernels.dropout import Dropout

# --compute_dtype -> torch dtype (JAX models/regat.py `_DTYPES`)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dot_f32(x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """x @ w of the operands rounded to `compute_dtype`, summed and returned
    in f32, unrounded: JAX's `jnp.dot(x.astype(cd), w.astype(cd),
    preferred_element_type=jnp.float32)`. A bf16 matmul would round its
    output to bf16, so the rounded operands are widened back to f32 and
    multiplied in f32, which is exact: a product of two bf16 values fits
    f32's mantissa. At f32 it is a plain matmul."""
    return torch.matmul(x.to(compute_dtype).float(), w.to(compute_dtype).float())


def glorot_uniform(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Keras' default Dense kernel init; fans from the first and last dims."""
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def orthogonal(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Keras' default GRU recurrent kernel init: Q of a QR of a normal matrix,
    signs fixed by R's diagonal."""
    rows, cols = shape
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q.T if rows < cols else q).contiguous()


def normal(
    shape: Sequence[int], generator: torch.Generator, stddev: float = 0.05
) -> torch.Tensor:
    """Keras' 'random_normal' initializer (stddev 0.05)."""
    return stddev * torch.randn(tuple(shape), generator=generator)


# data-parallel ranks take microbatch indices this far apart in step_seed
RANK_STRIDE = 1 << 16


def step_seed(base_seed: int, step: int, microbatch: int = 0, rank: int = 0) -> int:
    """The 64-bit seed of (base_seed, step, microbatch, rank): one per train
    step, as the JAX step folds the step into its base key, under gradient
    accumulation one per microbatch, as JAX folds the microbatch index in
    after it, and under data parallelism one per rank (a deviation: JAX
    draws one mask over the global batch, which torch cannot replay). Rank r's
    microbatch a takes the index i = a + r * RANK_STRIDE. The seed's halves
    are base_seed and step, each plus i times an odd constant (the golden
    ratio's 2**32 multiple), modulo 2**32, so microbatch 0 of rank 0 is the
    single-pass step's seed. The upper half is a bijection of i: no two
    (step, microbatch, rank) of one base seed share a 64-bit seed (the
    card's Philox generator) while a < RANK_STRIDE. The CPU's mt19937 keeps
    the lower half only; there (step, microbatch) of one rank still differ
    for steps within 8.2 million of each other at up to 256 microbatches."""
    mix = (microbatch + rank * RANK_STRIDE) * 0x9E3779B9
    hi = (base_seed + mix) & 0xFFFFFFFF
    return (hi << 32) | ((step + mix) & 0xFFFFFFFF)


def step_generator(base_seed: int, step: int, device, microbatch: int = 0,
                   rank: int = 0) -> torch.Generator:
    """A generator on `device` seeded with step_seed(base_seed, step,
    microbatch). `manual_seed` resets a generator's offset, so a generator
    re-seeded so draws what a new one draws: a CUDA graph keeps its
    generators and re-seeds them before each replay (train/graphs.py)."""
    g = torch.Generator(device=device)
    g.manual_seed(step_seed(base_seed, step, microbatch, rank))
    return g


def drop_threshold(rate: float) -> int:
    """The JAX package's quantised drop probability t/256, t in [1, 255]."""
    return min(255, max(1, int(round(rate * 256.0))))


def dropout_draw(
    shape: Sequence[int], rate: float, generator: Optional[torch.Generator],
    device: torch.device,
) -> Tuple[torch.Tensor, int]:
    """One dropout site's draw at `rate`: (one uint8 per element on `device`,
    the threshold t it is kept at, where it is >= t). Raises without a
    generator, or when the generator lives on another device."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    bits = torch.randint(
        0, 256, tuple(shape), generator=generator, dtype=torch.uint8, device=device
    )
    return bits, drop_threshold(rate)


def keep_mask(
    shape: Sequence[int], rate: float, generator: Optional[torch.Generator],
    device: torch.device,
) -> torch.Tensor:
    """Bool keep-mask: the draw, kept where it is >= t (nn.py:74-77)."""
    bits, t = dropout_draw(shape, rate, generator, device)
    return bits >= t


def dropout(
    x: torch.Tensor,
    rate: float,
    train: bool,
    generator: Optional[torch.Generator] = None,
    part: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Inverted dropout with the JAX package's 8-bit scheme (nn.py:52-77):
    the drop probability quantises to t/256 and the scale uses the quantised
    value, so E[dropout(x)] == x exactly; the scale is rounded to x's dtype
    first (1.25 for rate 0.2 in bf16), as JAX's is. Identity unless
    `train`. With `part` (i, n), x is part i of n of a tensor split on its
    last axis: the mask is drawn for the whole tensor and its part i taken,
    so the parts draw what the whole draws. The draw is applied by
    ops/kernels/dropout.py's `Dropout` (one kernel forward and one backward
    on the card, saving only the draw; `torch.where` on the CPU)."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    if part is None:
        bits, t = dropout_draw(x.shape, rate, generator, x.device)
    else:
        i, n = part
        w = x.shape[-1]
        bits, t = dropout_draw(x.shape[:-1] + (w * n,), rate, generator, x.device)
        bits = bits[..., i * w:(i + 1) * w]
    scale = 256.0 / (256 - t)
    if x.dtype != torch.float32:
        scale = float(torch.tensor(scale, dtype=x.dtype))
    return Dropout.apply(x, bits, t, scale)
