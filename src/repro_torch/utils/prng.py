"""Counter-based PRNG that reproduces ``jax.random`` bit for bit.

The JAX package forks every random stream by name from one experiment key
(``fold_in_str``), and the port must draw the same streams: the tests hold a
whole round of the port against the JAX round from the same state, and the
draws happen inside the round.  So this module implements JAX's default
generator, ``threefry2x32`` with ``jax_threefry_partitionable=True``, and the
samplers built on it (``uniform``, ``normal``, ``truncated_normal``,
``bernoulli``, ``randint``, ``permutation``, ``categorical``,
``exponential``, ``loggamma``, ``dirichlet``) with the same bit recipes.

A key is an int64 tensor of shape ``(..., 2)`` holding the two uint32 words
of a JAX key; leading dimensions batch keys the way ``vmap`` batches them in
JAX.  uint32 arithmetic runs on int64 tensors with explicit 32-bit masks, so
everything here runs on any device.  Nothing reads torch's global RNG.
Samplers draw on ``device`` (default: the key's device) and return shape
``key.shape[:-1] + shape``.  ``bits``, ``uniform`` and ``truncated_normal``
take a ``start``: they then draw elements ``[start, start + prod(shape))`` of
the flat counter; or an ``at``, an int64 tensor of flat element indices, to
draw those elements (shaped as ``at``).  Element ``i``'s bits depend only on
the key and ``i``, so a large draw made range by range, or a block of it
drawn index by index (a rank's shard of a weight), is the single draw, bit
for bit.

Integers and booleans (bits, ``randint``, ``bernoulli``, ``permutation``,
keys) and ``uniform`` match JAX exactly; ``categorical`` is an argmax over
Gumbel noise, exact wherever no two candidates come within an ulp.  ``normal`` and
``truncated_normal`` evaluate XLA's float32 ``erf_inv`` polynomial with its
multiply-adds rounded once, as XLA contracts them into FMAs; they agree to
an ulp (``log1p`` and ``sqrt`` round differently in a few per cent of
draws).
"""
from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block hash (20 rounds), on ints or int64 tensors.

    Arguments broadcast; every value is a uint32 word held in int64.
    """
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)``: the words ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
                        device=device)


def wrap_key_data(words) -> torch.Tensor:
    """A key from its uint32 words (numpy array, list or tensor)."""
    if isinstance(words, torch.Tensor):
        t = words.to(torch.int64)
    else:
        import numpy as np

        t = torch.tensor(np.asarray(words).astype(np.int64))
    return (t & _MASK).contiguous()


def key_data(k: torch.Tensor):
    """The key's uint32 words as a numpy array (``jax.random.key_data``)."""
    import numpy as np

    return k.detach().cpu().numpy().astype(np.uint32)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)`` under ``k``.

    ``data`` is an int or an integer tensor that broadcasts against the key
    batch (so ``fold_in(k, torch.arange(n))`` gives ``n`` keys).
    """
    if isinstance(data, torch.Tensor):
        data = data.to(device=k.device, dtype=torch.int64)
        y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], torch.zeros_like(data)
                              [..., None], (data & _MASK)[..., None])
        return torch.cat([y0, y1], dim=-1)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, int(data) & _MASK)
    return torch.stack([y0, y1], dim=-1)


def fold_in_str(k: torch.Tensor, tag: str) -> torch.Tensor:
    """Fold a string tag into a key: the JAX package's ``utils.fold_in_str``."""
    digest = hashlib.sha256(tag.encode("utf-8")).digest()
    return fold_in(k, int.from_bytes(digest[:4], "little"))


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like under partitionable threefry).

    Returns ``k.shape[:-1] + (num, 2)``; key ``i`` equals ``fold_in(k, i)``.
    """
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def _shape(shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def bits(k: torch.Tensor, shape: Sequence[int] = (), device=None,
         start: int = 0, at: torch.Tensor | None = None) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2**32)), ``jax.random.bits``;
    elements ``[start, start + prod(shape))`` of the flat draw, or, with
    ``at``, the elements at those flat indices (shape ``at.shape``)."""
    device = k.device if device is None else torch.device(device)
    k = k.to(device)
    if at is not None:
        shape = tuple(at.shape)
        counts = at.to(device=device, dtype=torch.int64).reshape(-1)
    else:
        shape = _shape(shape)
        counts = torch.arange(start, start + math.prod(shape), dtype=torch.int64,
                              device=device)
    batch = k.shape[:-1]
    k0 = k[..., 0].reshape(batch + (1,))
    k1 = k[..., 1].reshape(batch + (1,))
    b0, b1 = threefry2x32(k0, k1, counts >> 32, counts & _MASK)
    return (b0 ^ b1).reshape(batch + shape)


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's contracted FMA rounds it
    (the float32 product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def uniform(k: torch.Tensor, shape: Sequence[int] = (), minval=0.0, maxval=1.0,
            device=None, start: int = 0, at: torch.Tensor | None = None) -> torch.Tensor:
    """float32 uniform in ``[minval, maxval)`` from the top 23 bits."""
    device = k.device if device is None else torch.device(device)
    b = bits(k, shape, device, start, at)
    fb = (b >> 9) | 0x3F800000
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _as_f32(minval, device), _as_f32(maxval, device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


# XLA's float32 ErfInv (Giles' single-precision approximation): the two
# polynomial branches split at w = -log1p(-x^2) = 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, as XLA lowers ``lax.erf_inv``."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_SMALL[0], _ERFINV_LARGE[0]).to(x.dtype)
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, torch.where(lt, a, b).to(x.dtype))
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, p * x)


_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))
# the float32 just above -1: normal draws stay off erf_inv's pole at -1
_NEXT_ABOVE_MINUS_ONE = float(torch.nextafter(
    torch.tensor(-1.0, dtype=torch.float32), torch.tensor(0.0, dtype=torch.float32)))


def normal(k: torch.Tensor, shape: Sequence[int] = (), device=None,
           start: int = 0, at: torch.Tensor | None = None) -> torch.Tensor:
    """Standard normal: ``sqrt(2) * erf_inv(u)``, u uniform on (-1, 1)."""
    u = uniform(k, shape, _NEXT_ABOVE_MINUS_ONE, 1.0, device, start, at)
    return _SQRT2 * erf_inv(u)


def truncated_normal(k: torch.Tensor, lower: float, upper: float,
                     shape: Sequence[int] = (), device=None, start: int = 0,
                     at: torch.Tensor | None = None) -> torch.Tensor:
    """Standard normal truncated to the open interval ``(lower, upper)``."""
    device = k.device if device is None else torch.device(device)
    lo, hi = _as_f32(lower, device), _as_f32(upper, device)
    a = torch.special.erf(lo / _SQRT2)
    b = torch.special.erf(hi / _SQRT2)
    u = uniform(k, shape, a, b, device, start, at)
    out = _SQRT2 * erf_inv(u)
    inf = _as_f32(math.inf, device)
    return torch.clamp(out, torch.nextafter(lo, inf), torch.nextafter(hi, -inf))


def bernoulli(k: torch.Tensor, p: float = 0.5, shape: Sequence[int] = (),
              device=None) -> torch.Tensor:
    """Bool draws: ``uniform < p`` (JAX's ``mode='low'``)."""
    device = k.device if device is None else torch.device(device)
    return uniform(k, shape, device=device) < _as_f32(p, device)


def randint(k: torch.Tensor, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """int64 draws in ``[minval, maxval)`` by JAX's two-word modulus recipe.

    Matches ``jax.random.randint`` for int32 outputs whose ``maxval`` fits
    int32 (every call site of the port).
    """
    device = k.device if device is None else torch.device(device)
    ks = split(k.to(device))
    hi_bits = bits(ks[..., 0, :], shape, device)
    lo_bits = bits(ks[..., 1, :], shape, device)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((hi_bits % span) * mult) & _MASK) + (lo_bits % span)
    off = (off & _MASK) % span
    return minval + off


def permutation(k: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: stable sorts on fresh 32-bit keys."""
    device = k.device if device is None else torch.device(device)
    k = k.to(device)
    x = torch.arange(n, dtype=torch.int64, device=device).expand(
        k.shape[:-1] + (n,))
    uint32max = 2 ** 32 - 1
    num_rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(uint32max)))
    for _ in range(num_rounds):
        ks = split(k)
        k, sub = ks[..., 0, :], ks[..., 1, :]
        sort_keys = bits(sub, (n,), device)
        order = torch.sort(sort_keys, dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


_TINY = float(torch.finfo(torch.float32).tiny)


def categorical(k: torch.Tensor, logits: torch.Tensor, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """``jax.random.categorical(k, logits, shape=shape)`` over the last axis
    of ``logits`` (with replacement): the Gumbel-max draw ``argmax(g +
    logits)``, first index on ties, with JAX's ``mode='low'`` Gumbel noise
    ``g = -log(-log(u))``, u uniform on ``[tiny, 1)`` -> int64.  One key and
    1-D logits give ``shape``; a batch of keys ``(..., 2)`` with logits
    ``(..., classes)`` gives ``(...) + shape``, as ``jax.vmap`` of the one-key
    draw does."""
    device = k.device if device is None else torch.device(device)
    shape = _shape(shape)
    u = uniform(k, shape + (logits.shape[-1],), _TINY, 1.0, device)
    g = -torch.log(-torch.log(u))
    logits = logits.to(device=device, dtype=torch.float32)
    logits = logits.reshape(logits.shape[:-1] + (1,) * len(shape) + logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)


def exponential(k: torch.Tensor, shape: Sequence[int] = (), device=None) -> torch.Tensor:
    """``jax.random.exponential``: ``-log1p(-u)``, u uniform on [0, 1)."""
    return -torch.log1p(-uniform(k, shape, device=device))


_THIRD = float(torch.tensor(1.0 / 3.0, dtype=torch.float32))
_SQUEEZE = float(torch.tensor(0.0331, dtype=torch.float32))


def loggamma(k: torch.Tensor, alpha, shape: Sequence[int] | None = None,
             device=None) -> torch.Tensor:
    """``jax.random.loggamma(k, alpha, shape)``: the log of Gamma(alpha, 1)
    draws in float32, JAX's ``_gamma_one`` with ``log_space=True``.

    Element i of the flattened (broadcast) ``alpha`` draws from ``split(k,
    numel)[i]`` by Marsaglia and Tsang's rejection: ``d = a - 1/3``, ``c =
    (1/3) / sqrt(d)``; a pass splits its key into three, draws normals ``x``
    on the second (splitting it again each time) until ``v = 1 + x c > 0``,
    and a uniform ``U`` on the third; it accepts ``V = v^3`` once ``U < 1 -
    0.0331 x^4`` or ``log U < x^2 / 2 + d (1 - V + log V)``.  ``alpha < 1``
    draws at ``alpha + 1`` and adds ``log(u') / alpha`` (``u'`` the key's other
    half's ``-exponential``).  JAX's per-element while loops run here on
    every element at once, each element's state advancing under a mask until
    all accept; each pass reads one bool back to the host."""
    device = k.device if device is None else torch.device(device)
    k = k.to(device)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    out_shape = tuple(alpha.shape) if shape is None else _shape(shape)
    a = alpha.expand(out_shape).reshape(-1)
    keys = split(k, a.numel())  # (n, 2)
    boost = a >= 1.0
    ab = torch.where(boost, a, a + 1.0)
    d = ab - _THIRD
    c = _THIRD / torch.sqrt(d)
    ks = split(keys)
    key, subkey = ks[:, 0], ks[:, 1]

    def rejected(X, V, U):  # JAX's loop condition
        return (U >= 1.0 - _SQUEEZE * (X * X)) & (
            torch.log(U) >= X * 0.5 + d * ((1.0 - V) + torch.log(V)))

    X = torch.zeros_like(a)
    V = torch.ones_like(a)
    U = torch.full_like(a, 2.0)
    todo = rejected(X, V, U)  # the start state is rejected everywhere
    while bool(todo.any()):
        k3 = split(key, 3)
        key = torch.where(todo[:, None], k3[:, 0], key)
        x_key = k3[:, 1]
        x = torch.zeros_like(a)
        v = torch.full_like(a, -1.0)
        redraw = todo.clone()
        while bool(redraw.any()):
            k2 = split(x_key)
            x_key = torch.where(redraw[:, None], k2[:, 0], x_key)
            xn = normal(k2[:, 1], (), device)
            x = torch.where(redraw, xn, x)
            v = torch.where(redraw, _fma(xn, c, torch.ones_like(xn)), v)
            redraw = redraw & (v <= 0.0)
        un = uniform(k3[:, 2], (), device=device)
        X = torch.where(todo, x * x, X)
        V = torch.where(todo, (v * v) * v, V)
        U = torch.where(todo, un, U)
        todo = todo & rejected(X, V, U)
    log_samples = -exponential(subkey, (), device)
    log_boost = torch.where(boost | (log_samples == 0.0), torch.zeros_like(a),
                            log_samples * (1.0 / a))
    return ((torch.log(d) + torch.log(V)) + log_boost).reshape(out_shape)


def dirichlet(k: torch.Tensor, alpha, shape: Sequence[int] | None = None,
              device=None) -> torch.Tensor:
    """``jax.random.dirichlet(k, alpha, shape)``: the softmax over the last axis
    of ``loggamma`` draws at ``alpha`` broadcast to ``shape + alpha.shape[-1:]``
    -> float32 of that shape."""
    device = k.device if device is None else torch.device(device)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    shape = tuple(alpha.shape[:-1]) if shape is None else _shape(shape)
    g = loggamma(k, alpha, shape + tuple(alpha.shape[-1:]), device)
    e = torch.exp(g - g.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)
