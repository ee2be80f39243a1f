"""The port's threefry2x32 key chain: JAX 0.9.0's default PRNG with
``jax_threefry_partitionable`` on, written from the algorithm (Salmon et
al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011) so that the
port samples the reference's tokens from the same keys.

A key is a pair of uint32 words ``(k0, k1)``, held as Python ints: the
key chain (``PRNGKey``, ``split``, ``fold_in``) runs on the host in a few
microseconds and never touches a device.  Only a draw (``random_bits``,
``uniform``, ``gumbel``, ``categorical``) makes tensors, on the device of
its logits or the one given.  torch's ``uint32`` has few kernels, so the
words are computed in ``int64`` masked to 32 bits.

The pieces, as JAX defines them (``jax/_src/prng.py``,
``jax/_src/random.py``):

* ``threefry2x32``: 20 rounds in five groups of four, rotations
  (13, 15, 26, 6) and (17, 29, 16, 24) alternating, a key injection after
  each group from the schedule ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA`` plus the
  group's index;
* ``PRNGKey(seed)``: ``(0, seed mod 2^32)`` (JAX without x64 takes a
  seed's low 32 bits, and its high word is then 0);
* ``split(key, n)``: key ``i`` is ``threefry2x32(key, (0, i))``, the
  partitionable, fold-like split over the ``iota_2x32_shape`` counters;
* ``fold_in(key, d)``: ``threefry2x32(key, (0, d))``, so
  ``fold_in(key, i) == split(key, n)[i]``;
* ``random_bits(key, shape)``: element ``i`` (row-major) of the draw is
  the xor of the two words of ``threefry2x32(key, (i >> 32, i & M))``;
* ``uniform``: 23 random mantissa bits under the exponent of 1.0, minus
  1, scaled into ``[minval, maxval)``; ``gumbel``: ``-log(-log(u))`` of a
  uniform draw on ``[tiny, 1)`` (JAX's ``mode='low'``); ``categorical``:
  the argmax of gumbel noise plus the logits.

The data stream's draws (``data.pipeline``, ``models.model.
example_batch``), as JAX 0.9.0 defines them (``jax/_src/random.py``):

* ``randint(key, shape, lo, hi)`` (int32): two bit streams from
  ``split(key)``'s keys, ``hi_bits`` and ``lo_bits``; with ``span = hi -
  lo`` and ``mult = (2^16 mod span)^2 mod span`` in uint32 arithmetic
  (the square wraps), the draw is ``lo + ((hi_bits mod span) · mult +
  lo_bits mod span) mod span``, every product and sum wrapping at 2^32;
* ``bernoulli(key, p, shape)``: ``uniform(key, shape) < p`` in float32;
* ``normal(key, shape)``: ``sqrt(2) · erfinv(u)`` for ``u`` uniform on
  ``[nextafter(-1, 0), 1)``, in float32.

The raw bits, and so ``uniform``, ``randint`` and ``bernoulli``, are
exact on every device; ``normal`` goes through ``erfinv``, whose float32
approximations differ by a few ulps between XLA and torch (and between the
card and the host).  ``log``
differs by an ulp between libraries, so a categorical draw agrees with
JAX's (and the card's with the host's) except where the top two perturbed
scores nearly tie.

``categorical_rows`` is the scheduler's batched lane draw: row ``l`` is
``categorical(keys[l], logits[l:l + 1])``, the draw of a ``(1, V)`` batch
for that lane's key, all rows in one pass.  Under the partitionable scheme
a row's counters depend only on its position within ``(1, V)``, so the
batch is bit for bit the L separate draws.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

Key = Tuple[int, int]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32's smallest normal, the low end of gumbel's uniform draw
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds, on uint32 words held in
    Python ints or int64 tensors (broadcast together).  Returns the two
    output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``'s key data."""
    return (0, int(seed) & MASK)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)``: ``num`` new keys."""
    k0, k1 = key
    return [threefry2x32(k0, k1, 0, i) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    k0, k1 = key
    return threefry2x32(k0, k1, 0, int(data) & MASK)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The high and low words of each element's row-major index."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def _keys_tensor(keys: Sequence[Key], device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """A (L, 1) column of each key word, on ``device``."""
    kk = torch.tensor([[k0, k1] for k0, k1 in keys], dtype=torch.int64)
    kk = kk.to(device)
    return kk[:, 0:1], kk[:, 1:2]


def _bits(k0, k1, shape, device) -> torch.Tensor:
    hi, lo = _counters(shape, device)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return b0 ^ b1


def random_bits(key: Key, shape: Sequence[int], device=None
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): uint32 values in an int64
    tensor of ``shape`` on ``device`` (default the CPU)."""
    k0, k1 = key
    return _bits(k0, k1, tuple(shape), device or "cpu")


def _full(value: float, device) -> torch.Tensor:
    """A 0-dim float32 tensor made on ``device`` (a fill, no host copy)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _to_uniform(bits: torch.Tensor, minval: float, maxval: float
                ) -> torch.Tensor:
    """JAX's bits -> float32 on ``[minval, maxval)``: the top 23 bits as
    the mantissa of a float in [1, 2), minus 1, then ``u * (maxval -
    minval) + minval`` rounded once (XLA fuses it into one multiply-add),
    floored at ``minval``.  Where ``maxval - minval`` is 1 in float32 (the
    gumbel draw's ``[tiny, 1)``) the product is exact and float32 does it;
    elsewhere the product, exact in float64, is added there and rounded
    to float32."""
    one = 0x3F800000
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = _full(minval, bits.device)
    scale = float(np.float32(maxval) - np.float32(minval))
    if scale == 1.0:
        out = floats + lo
    else:
        out = (floats.double() * scale + lo.double()).float()
    return torch.maximum(lo, out)


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _to_uniform(random_bits(key, shape, device), minval, maxval)


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): int32
    values on ``device``.  A span of 2^32 (the whole int32 range) is not
    drawn."""
    i32 = (-(1 << 31), (1 << 31) - 1)
    out_of_range = maxval > i32[1]
    minval = min(max(int(minval), i32[0]), i32[1])
    maxval = min(max(int(maxval), i32[0]), i32[1])
    span = (maxval - minval) & MASK if maxval > minval else 1
    if out_of_range and maxval > minval:
        span = (span + 1) & MASK
    if span == 0:
        raise ValueError("randint: a span of 2^32 is not supported")
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    # (higher mod span) · mult mod 2^32, in int64 without overflow: mult
    # in 16-bit halves, each partial product under 2^48
    a = higher % span
    prod = ((a * (mult >> 16) & 0xFFFF) << 16) + a * (mult & 0xFFFF)
    offset = (((prod & MASK) + lower % span) & MASK) % span
    return (offset + minval).to(torch.int32)


def bernoulli(key: Key, p: float, shape: Sequence[int], device=None
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (``mode='low'``): bool."""
    return uniform(key, shape, device=device) < _full(p, device or "cpu")


# float32's sqrt(2) and the low end of normal's uniform draw
_SQRT2 = float(np.float32(np.sqrt(2)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) ·
    erfinv(u)``, u uniform on ``[nextafter(-1, 0), 1)``.  The uniform draw
    is exact; ``erfinv`` is torch's, a few float32 ulps from XLA's."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, device)
    return torch.erfinv(u) * _full(_SQRT2, u.device)


def _gumbel_of(bits: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(_to_uniform(bits, _TINY, 1.0)))


def gumbel(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (``mode='low'``)."""
    return _gumbel_of(random_bits(key, shape, device))


def _check_logits(logits: torch.Tensor) -> None:
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical draws float32 gumbel noise, as JAX "
                        f"does for float32 logits; got {logits.dtype}")


def categorical(key: Key, logits: torch.Tensor, axis: int = -1
                ) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: one draw per row of
    ``logits`` (float32), on its device."""
    _check_logits(logits)
    k0, k1 = key
    noise = _gumbel_of(_bits(k0, k1, tuple(logits.shape), logits.device))
    return torch.argmax(noise + logits, dim=axis)


def categorical_rows(keys: Sequence[Key], logits: torch.Tensor
                     ) -> torch.Tensor:
    """One draw per row of ``logits`` (L, V), row ``l`` with ``keys[l]``:
    ``categorical(keys[l], logits[l:l + 1])[0]`` for every l, in one
    pass."""
    _check_logits(logits)
    if logits.dim() != 2 or len(keys) != logits.shape[0]:
        raise ValueError(f"categorical_rows takes (L, V) logits and L keys; "
                         f"got {tuple(logits.shape)} and {len(keys)} keys")
    k0, k1 = _keys_tensor(keys, logits.device)
    noise = _gumbel_of(_bits(k0, k1, (logits.shape[1],), logits.device))
    return torch.argmax(noise + logits, dim=-1)


def scaled(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """``logits / temperature`` in float32, a true division on every
    device (a 0-dim tensor divisor: CUDA's division by a host scalar
    multiplies by its reciprocal, which rounds otherwise)."""
    return logits.float() / _full(temperature, logits.device)


__all__ = ["Key", "PRNGKey", "split", "fold_in", "threefry2x32",
           "random_bits", "uniform", "randint", "bernoulli", "normal",
           "gumbel", "categorical", "categorical_rows", "scaled"]
