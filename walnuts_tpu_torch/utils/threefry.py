"""JAX's threefry2x32 random stream in torch, bit for bit.

The scan engine (:mod:`..sampler.transition`) draws all its randomness
through ``jax.random`` keys, so its port reproduces that stream rather
than drawing from a ``torch.Generator``: the same seed gives the same
momenta, directions, step-size jitter and selection coins as the JAX
package.  What is reproduced is JAX 0.9 with
``jax_threefry_partitionable=True`` (its default):

* :func:`PRNGKey` is ``jax.random.PRNGKey`` on a raw key (``prng.py``
  ``threefry_seed``: the seed's high and low 32-bit words);
* :func:`split` and :func:`fold_in` are the fold-like split and
  ``threefry_fold_in``;
* :func:`random_bits` is ``_threefry_random_bits_partitionable`` (the
  flat element index as a 64-bit counter, split into two words);
* :func:`uniform`, :func:`normal` and :func:`bernoulli` follow
  ``random.py``'s ``_uniform``, ``_normal_real`` and ``_bernoulli``
  (mode ``"low"``), with XLA's ``erf_inv`` polynomials.

Because the counter is the flat index into the draw's global shape, the
draws of a block of the draw are those counters alone: each of
:func:`random_bits`, :func:`uniform`, :func:`bernoulli` and
:func:`normal` takes ``rows=(r0, r1)`` (leading axis) and ``cols=(c0,
c1)`` (last axis) and returns ``full[r0:r1, ..., c0:c1]`` bit for bit
while hashing only its own counters (a window of columns is a strided
set of them), so a rank that holds rows ``r0 .. r1`` of a chain batch,
and columns ``c0 .. c1`` of its positions, draws what a single process
would draw for them.  :func:`randint` takes ``rows``.

A key is an int64 tensor of shape ``[..., 2]`` holding two uint32 words:
torch has no uint32 arithmetic on the CPU, so the words ride in int64
and every sum is masked back to 32 bits (threefry needs only add, xor
and rotate).  Every function takes a batch of keys (leading dims) and
broadcasts them against the draw's shape, so a transition's per-step
keys and draws are computed in one pass.

Dtypes follow JAX with x64 on: a draw without a dtype is float64.  A
JAX run without x64 draws such coins in float32, from other bits.
"""

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter words
    ``(x1, x2)`` under the key words ``(k1, k2)``; all int64 tensors of
    uint32 values, broadcast together.  Returns two words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, device=None):
    """``jax.random.PRNGKey(seed)``: the 64-bit seed's high and low
    words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split27(a):
    c = 134217729.0 * a                       # 2^27 + 1 (Dekker)
    hi = c - (c - a)
    return hi, a - hi


def fma(a, b, c):
    """``a * b + c`` with one rounding, as XLA's CPU backend contracts
    a multiply feeding an add (``jax.random.uniform``'s scaling and the
    ``erf_inv`` Horner steps).  float32 goes through float64, where the
    product is exact; float64 uses Dekker's exact product and a
    two-sum, which rounds once except in double-rounding ties."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    p = a * b
    ah, al = _split27(a)
    bh, bl = _split27(torch.as_tensor(b, dtype=a.dtype, device=a.device))
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s, t = _two_sum(p, torch.as_tensor(c, dtype=a.dtype, device=a.device))
    return s + (t + e)


def _hash_index(key, idx):
    """Hash the counters ``idx`` (an int64 tensor ``[n]`` of values below
    2^32; high word 0) under a batch of keys ``[..., 2]``: two words of
    shape ``[..., n]``."""
    k1, k2 = key[..., 0, None], key[..., 1, None]
    return threefry2x32(k1, k2, torch.zeros_like(idx), idx)


def split(key, num: int = 2):
    """``jax.random.split(key, num)``: ``[..., 2] -> [..., num, 2]``."""
    b1, b2 = _hash_index(key, torch.arange(num, dtype=torch.int64,
                                           device=key.device))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for an int or an int tensor of
    data (broadcast against the key's batch dims): ``threefry_2x32``
    of the counter pair ``(0, data)``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def _window(shape, rows, cols, device):
    """``(counters [n], output shape)`` of the window ``rows = (r0, r1)``
    of the leading axis and ``cols = (c0, c1)`` of the last axis of a
    draw of global ``shape`` (each whole for ``None``)."""
    def bounds(win, axis, name):
        lo, hi = (int(x) for x in win)
        if not shape or not 0 <= lo <= hi <= shape[axis]:
            raise ValueError(f"{win} outside the {name} axis of {shape}")
        return lo, hi

    if rows is None and cols is None:
        return torch.arange(math.prod(shape), dtype=torch.int64,
                            device=device), shape
    r0, r1 = (0, shape[0]) if rows is None else bounds(rows, 0, "leading")
    if cols is None:
        inner = math.prod(shape[1:])
        return (torch.arange(r0 * inner, r1 * inner, dtype=torch.int64,
                             device=device), (r1 - r0,) + shape[1:])
    if len(shape) < 2:
        raise ValueError(f"a column window needs a draw of two axes or "
                         f"more, got {shape}")
    c0, c1 = bounds(cols, -1, "last")
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)[r0:r1, ..., c0:c1]
    return idx.reshape(-1), tuple(idx.shape)


def random_bits(key, bit_width: int, shape, rows=None, cols=None):
    """``jax.random.bits``: ``[..., 2]`` keys -> ``[..., *shape]`` words
    (32-bit as int64 values below 2^32; 64-bit as the high and low
    words ``(hi, lo)``).  ``rows=(r0, r1)`` and ``cols=(c0, c1)`` return
    that window of the leading and the last axis of ``shape`` alone."""
    idx, out_shape = _window(tuple(shape), rows, cols, key.device)
    b1, b2 = _hash_index(key, idx)
    lead = key.shape[:-1]
    b1 = b1.reshape(lead + out_shape)
    b2 = b2.reshape(lead + out_shape)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return b1, b2
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def uniform(key, shape, dtype=torch.float64, minval=0.0, maxval=1.0,
            rows=None, cols=None):
    """``jax.random.uniform``: the mantissa bits under the exponent of
    1.0, minus one, scaled to ``[minval, maxval)`` in ``dtype``
    (``rows`` and ``cols`` as in :func:`random_bits`)."""
    if dtype == torch.float64:
        hi, lo = random_bits(key, 64, shape, rows, cols)
        # the top 52 of the 64 bits, ORed into 1.0's exponent
        fb = ((hi << 20) | (lo >> 12)) | 0x3FF0000000000000
        floats = fb.view(torch.float64) - 1.0
    elif dtype == torch.float32:
        fb = (random_bits(key, 32, shape, rows, cols) >> 9) | 0x3F800000
        floats = fb.to(torch.int32).view(torch.float32) - 1.0
    else:
        raise ValueError(f"uniform draws float32 or float64, got {dtype}")
    lo_v = torch.as_tensor(minval, dtype=dtype, device=key.device)
    hi_v = torch.as_tensor(maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo_v, fma(floats, hi_v - lo_v, lo_v))


def randint(key, shape, minval, maxval, dtype=torch.int64, rows=None):
    """``jax.random.randint(key, shape, minval, maxval, dtype)`` for int
    bounds with ``0 < maxval - minval < 2^31``: two words of random
    bits per value (``split(key)``'s two keys), folded modulo the span
    as JAX folds them.  ``dtype`` is ``torch.int32`` (32-bit words,
    uint32 arithmetic) or ``torch.int64`` (64-bit words; JAX's default
    int with x64 on).  ``rows`` as in :func:`random_bits`."""
    minval, maxval = int(minval), int(maxval)
    span = maxval - minval
    if not 0 < span < 2 ** 31:
        raise ValueError(f"randint needs 0 < maxval - minval < 2^31, got "
                         f"[{minval}, {maxval})")
    k1, k2 = split(key).unbind(-2)
    if dtype == torch.int32:
        hi = random_bits(k1, 32, shape, rows)
        lo = random_bits(k2, 32, shape, rows)
        # 2^32 mod span, then the two words' residues, in uint32
        mult = (((1 << 16) % span) ** 2 & _M32) % span
        off = ((hi % span) * mult & _M32) + lo % span
        off = (off & _M32) % span
    elif dtype == torch.int64:
        # a 64-bit word (h, l) is h 2^32 + l; with span < 2^31 no
        # product below leaves int64, as none wraps in JAX's uint64
        def rem64(words):
            h, l = words
            return ((h % span) * ((1 << 32) % span) + l % span) % span

        mult = (((1 << 32) % span) ** 2) % span
        off = (rem64(random_bits(k1, 64, shape, rows)) * mult
               + rem64(random_bits(k2, 64, shape, rows))) % span
    else:
        raise ValueError(f"randint draws int32 or int64, got {dtype}")
    return (off + minval).to(dtype)


def bernoulli(key, p=0.5, shape=(), dtype=torch.float64, rows=None,
              cols=None):
    """``jax.random.bernoulli`` (mode ``"low"``): ``uniform < p``, drawn
    in ``p``'s dtype (float64 for a Python float under x64; ``rows`` and
    ``cols`` as in :func:`random_bits`)."""
    return uniform(key, shape, dtype, rows=rows, cols=cols) < p


def gumbel(key, shape, dtype=torch.float64):
    """``jax.random.gumbel`` (mode ``"low"``): ``-log(-log(u))`` for
    ``u`` uniform on ``[tiny, 1)``, ``tiny`` the dtype's smallest
    normal number."""
    u = uniform(key, shape, dtype, minval=torch.finfo(dtype).tiny,
                maxval=1.0)
    return -torch.log(-torch.log(u))


# XLA's erf_inv (chlo legalisation): Giles' single- and double-precision
# polynomials, evaluated by Horner's rule in the working dtype.
_ERFINV_F32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_ERFINV_F64_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV_F64_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV_F64_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def erf_inv(x):
    """XLA's ``erf_inv`` for float32 and float64 tensors."""
    w = -torch.log1p(-x * x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        lo, hi = _ERFINV_F32
        p = torch.where(lt, lo[0], hi[0]).to(x.dtype)
        for a, b in zip(lo[1:], hi[1:]):
            p = fma(p, w, torch.where(lt, a, b).to(x.dtype))
    else:
        lt6, lt16 = w < 6.25, w < 16.0

        def coef(i):
            c = torch.full_like(x, _ERFINV_F64_LT_6_25[i])
            if i < 19:
                c = torch.where(lt6, c, _ERFINV_F64_LT_16[i])
            if i < 17:
                c = torch.where(lt16, c, _ERFINV_F64_GE_16[i])
            return c

        sw = torch.sqrt(w)
        w = torch.where(lt6, w - 3.125,
                        sw - torch.where(lt16, 3.25, 5.0).to(x.dtype))
        p = coef(0)
        for i in range(1, 17):
            p = fma(p, w, coef(i))
        for i in range(17, 19):
            p = torch.where(lt16, fma(p, w, coef(i)), p)
        for i in range(19, 23):
            p = torch.where(lt6, fma(p, w, coef(i)), p)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def normal(key, shape, dtype=torch.float64, rows=None, cols=None):
    """``jax.random.normal``: ``sqrt(2) erf_inv(u)`` for ``u`` uniform
    on ``[nextafter(-1, 0), 1)`` (``rows`` and ``cols`` as in
    :func:`random_bits`)."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype)).item()
    u = uniform(key, shape, dtype, lo, 1.0, rows, cols)
    return torch.tensor(math.sqrt(2.0), dtype=dtype) * erf_inv(u)
