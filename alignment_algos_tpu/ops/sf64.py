"""Software IEEE-754 binary64 on uint32 pairs, exact f32 divide/sqrt, and
a bit-exact replica of this deployment's libm ``expf``.

Why this exists: the reference's similarity pipelines call libm float
transcendentals (``exp(float)`` in hmap_eval.h:56-60 resolves to glibc
expf) and rely on IEEE f32 division/sqrt (hmath.h norm_elements), and the
framework's parity contract is BIT equality with the compiled reference.
Under XLA:GPU's defaults f32 divide and sqrt are not correctly rounded
(on an H100, 38% of a million random divides and 17% of square roots
differ in the last bit; docs/DECISIONS.md) and exp is nowhere near
libm, while uint32 multiply / add / shifts ARE exact.  So the device
similarity producer (ops/hmap_device) computes every non-trivially-
roundable operation in integer arithmetic:

- ``fma64`` / ``mul64`` emulate binary64 exactly (normal range) on
  uint32 pairs, enough to replicate glibc 2.36's ``__expf_fma`` — the
  ifunc variant this machine resolves (disassembled from
  /lib/x86_64-linux-gnu/libm.so.6 at 0x72ba0; its f64 constant pool and
  32-entry 2^(i/32) table were extracted from rodata and are inlined
  below).  The oracle binaries and the host Python path
  (native/exactmath.c) link the same libm, so bit-matching this one
  function closes the whole transcendental parity gap.
- ``div32`` / ``sqrt32`` produce correctly-rounded f32 quotients and
  square roots via integer remainder correction (a float estimate is
  snapped to the true floor quotient/root by exact integer multiply-
  compare, then rounded half-even from the exact remainder).

Domain: normal (plus subnormal f32 inputs, which widen to normal f64)
values only; expf's main path covers |x| < 88 (the special-case branch
at __expf_fma+0x17 is never taken for the similarity arguments, which
the producer bounds by |alpha| * max-confidence^2 <= 4).  Exhaustive
validation against the live libm over the full f32 domain |x| <= 8 is in
tools/validate_expf.py; sampled validation runs in tests/test_sf64.py.

All functions are elementwise over same-shape jnp arrays and jit/fuse
cleanly on the CPU and GPU backends (pure uint32/int32 arithmetic).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U = jnp.uint32
I = jnp.int32


def f32_bits(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def bits_f32(b):
    return jax.lax.bitcast_convert_type(b, jnp.float32)


def nofma(x, z):
    """Defeat fmuladd contraction of add(mul(a,b), c).

    XLA's CPU emitter lowers a multiply feeding an add inside one fusion
    to llvm.fmuladd, which x86 fuses into a single-rounding FMA — a
    1-ulp break of the two-rounding parity contract (optimization
    barriers are stripped before fusion and do not help; measured).  A
    round-trip through an integer xor with a TRACED zero (``z`` must be
    a runtime argument, never a literal, or it constant-folds away)
    breaks the pattern without changing the value.  XLA:GPU left a plain
    a*b+c uncontracted on the H100 (docs/DECISIONS.md), but ptxas may
    fuse a mul.f32/add.f32 pair, so every site that must round twice
    keeps the guard on every backend."""
    return bits_f32(f32_bits(x) ^ z)


def _ilog2(v):
    """floor(log2(v)) for v > 0 (uint32) — 5 branchless halving steps.
    Returns int32; v == 0 gives 0."""
    e = jnp.zeros(v.shape, I)
    for k in (16, 8, 4, 2, 1):
        gt = v >= U(1 << k)
        e = e + jnp.where(gt, I(k), I(0))
        v = jnp.where(gt, v >> U(k), v)
    return e


# --------------------------------------------------------------------------
# wide unsigned integers: python lists of uint32 arrays, LSB word first
# --------------------------------------------------------------------------

def _wadd(a, b):
    """Ripple add of equal-length word lists (mod 2^(32n))."""
    out = []
    carry = None
    for x, y in zip(a, b):
        s = x + y
        if carry is not None:
            s2 = s + carry
            newc = jnp.where((s < x) | (s2 < s), U(1), U(0))
            s = s2
        else:
            newc = jnp.where(s < x, U(1), U(0))
        out.append(s)
        carry = newc
    return out


def _wsub(a, b):
    """a - b (mod 2^(32n)); caller guarantees a >= b for magnitudes."""
    out = []
    borrow = None
    for x, y in zip(a, b):
        d = x - y
        if borrow is not None:
            d2 = d - borrow
            newb = jnp.where((x < y) | (d < borrow), U(1), U(0))
            d = d2
        else:
            newb = jnp.where(x < y, U(1), U(0))
        out.append(d)
        borrow = newb
    return out


def _wlt(a, b):
    """a < b for equal-length word lists."""
    lt = None
    for x, y in zip(a, b):          # LSB to MSB; MSB decides
        if lt is None:
            lt = x < y
        else:
            lt = jnp.where(x == y, lt, x < y)
    return lt


def _wzero(a):
    nz = a[0] != U(0)
    for w in a[1:]:
        nz = nz | (w != U(0))
    return ~nz


def _wshl(a, s, nout):
    """Left shift word list ``a`` by per-element s (int32, >= 0) into
    ``nout`` words.  Bits shifted past the top are dropped (callers
    guarantee they are zero)."""
    w = list(a) + [jnp.zeros(a[0].shape, U)] * (nout - len(a))
    su = s.astype(U)
    nwords = (su >> U(5))
    for bit in (4, 2, 1):           # up to 7-word moves
        k = U(bit)
        do = (nwords & k) != U(0)
        shifted = [jnp.zeros(w[0].shape, U)] * bit + w[:-bit]
        w = [jnp.where(do, sw, ow) for sw, ow in zip(shifted, w)]
    bs = su & U(31)
    nz = bs != U(0)
    inv = jnp.where(nz, U(32) - bs, U(0))
    out = []
    prev = jnp.zeros(w[0].shape, U)
    for x in w:
        hi_in = jnp.where(nz, prev >> inv, U(0))
        out.append(jnp.where(nz, (x << bs) | hi_in, x))
        prev = x
    return out


def _wshr_sticky(a, s):
    """Right shift word list by per-element s (int32, >= 0); returns
    (words, sticky) where sticky is uint32 0/1 of all dropped bits."""
    w = list(a)
    n = len(w)
    su = s.astype(U)
    sticky = jnp.zeros(w[0].shape, U)
    nwords = su >> U(5)
    for bit in (4, 2, 1):
        k = U(bit)
        do = (nwords & k) != U(0)
        dropped = jnp.zeros(w[0].shape, U)
        for d in w[:bit]:
            dropped = dropped | d
        shifted = w[bit:] + [jnp.zeros(w[0].shape, U)] * min(bit, n)
        shifted = shifted[:n]
        sticky = sticky | jnp.where(do & (dropped != U(0)), U(1), U(0))
        w = [jnp.where(do, sw, ow) for sw, ow in zip(shifted, w)]
    bs = su & U(31)
    nz = bs != U(0)
    inv = jnp.where(nz, U(32) - bs, U(0))
    mask = jnp.where(nz, (U(1) << bs) - U(1), U(0))
    sticky = sticky | jnp.where((w[0] & mask) != U(0), U(1), U(0))
    out = []
    for i, x in enumerate(w):
        hi = w[i + 1] if i + 1 < n else jnp.zeros(x.shape, U)
        lo_part = jnp.where(nz, x >> bs, x)
        hi_part = jnp.where(nz, hi << inv, U(0))
        out.append(lo_part | hi_part)
    return out, sticky


def _wmsb(a):
    """Bit position of the highest set bit (int32); 0 if a == 0."""
    pos = jnp.zeros(a[0].shape, I)
    found = jnp.zeros(a[0].shape, jnp.bool_)
    for i in range(len(a) - 1, -1, -1):
        nz = a[i] != U(0)
        take = nz & ~found
        pos = jnp.where(take, I(32 * i) + _ilog2(a[i]), pos)
        found = found | nz
    return pos


# --------------------------------------------------------------------------
# binary64 pack/unpack (normal + zero only — domain-guarded)
# --------------------------------------------------------------------------

def _unpack64(hi, lo):
    """-> (sign_bool, e_unbiased int32, [mlo, mhi21] mantissa words with
    the implicit bit, is_zero)."""
    sign = (hi >> U(31)) != U(0)
    e = ((hi >> U(20)) & U(0x7FF)).astype(I) - I(1023)
    mhi = (hi & U(0xFFFFF)) | U(0x100000)
    is_zero = ((hi & U(0x7FFFFFFF)) == U(0)) & (lo == U(0))
    return sign, e, [lo, mhi], is_zero


def _pack64(sign, e_unb, mlo, mhi21):
    eb = (e_unb + I(1023)).astype(U)
    hi = (jnp.where(sign, U(1), U(0)) << U(31)) | (eb << U(20)) \
        | (mhi21 & U(0xFFFFF))
    return hi, mlo


def _round53(words, elsb, sign, sticky_in):
    """Round a wide magnitude (word list, value = W * 2^elsb, elsb int32
    per element) to nearest-even binary64.  Returns (hi, lo).  Zero wide
    with no sticky returns +0."""
    zero = _wzero(words) & (sticky_in == U(0))
    p = _wmsb(words)
    e_unb = p + elsb
    sh = p - I(52)
    # right-shift path: shift by sh-1, low bit is the round bit
    sh1 = jnp.maximum(sh - I(1), I(0))
    r_w, st = _wshr_sticky(words, sh1)
    sticky = sticky_in | st
    rbit = jnp.where(sh >= I(1), r_w[0] & U(1), U(0))
    m_r, _ = _wshr_sticky(r_w, jnp.where(sh >= I(1), I(1), I(0)))
    # left-shift path (value has <= 52 significant bits: exact)
    m_l = _wshl(words, jnp.maximum(-sh, I(0)), len(words))
    use_r = sh >= I(1)
    mlo = jnp.where(use_r, m_r[0], m_l[0])
    mhi = jnp.where(use_r, m_r[1], m_l[1])
    # round half to even
    inc = (rbit != U(0)) & ((sticky != U(0)) | ((mlo & U(1)) != U(0)))
    mlo2 = mlo + jnp.where(inc, U(1), U(0))
    carry = (mlo2 == U(0)) & inc
    mhi2 = mhi + jnp.where(carry, U(1), U(0))
    ovf = mhi2 == U(0x200000)        # mantissa reached 2^53
    mhi3 = jnp.where(ovf, U(0x100000), mhi2)
    e_out = e_unb + jnp.where(ovf, I(1), I(0))
    hi, lo = _pack64(sign, e_out, mlo2, mhi3)
    hi = jnp.where(zero, U(0), hi)
    lo = jnp.where(zero, U(0), lo)
    return hi, lo


# --------------------------------------------------------------------------
# conversions
# --------------------------------------------------------------------------

def f32_to_f64(bits):
    """Exact widening conversion (normal, subnormal and zero inputs)."""
    sign = bits & U(0x80000000)
    e = (bits >> U(23)) & U(0xFF)
    m = bits & U(0x7FFFFF)
    # normal
    hi_n = sign | ((e + U(896)) << U(20)) | (m >> U(3))
    lo_n = m << U(29)
    # subnormal: value m * 2^-149 = 1.f * 2^(eb-149), eb = floor(log2 m)
    eb = _ilog2(m).astype(U)
    sh = U(52) - eb                      # in [29, 52]
    big = sh >= U(32)
    sh_a = jnp.where(big, sh - U(32), U(0))       # guarded shifts < 32
    sh_b = jnp.where(big, U(1), U(32) - sh)
    sh_c = jnp.where(big, U(0), sh)
    hi_m = jnp.where(big, m << sh_a, m >> sh_b)
    lo_m = jnp.where(big, U(0), m << sh_c)
    hi_s = sign | ((eb + U(874)) << U(20)) | (hi_m & U(0xFFFFF))
    is_sub = (e == U(0)) & (m != U(0))
    is_zero = (e == U(0)) & (m == U(0))
    hi = jnp.where(is_sub, hi_s, hi_n)
    lo = jnp.where(is_sub, lo_m, lo_n)
    hi = jnp.where(is_zero, sign, hi)
    lo = jnp.where(is_zero, U(0), lo)
    return hi, lo


def f64_to_f32(hi, lo):
    """Round-to-nearest-even narrowing; result must be a normal f32 or
    zero (guaranteed over the validated expf domain)."""
    sign = hi & U(0x80000000)
    e = ((hi >> U(20)) & U(0x7FF)).astype(I)
    is_zero = ((hi & U(0x7FFFFFFF)) | lo) == U(0)
    m24 = ((hi & U(0xFFFFF)) << U(3)) | (lo >> U(29)) | U(0x800000)
    rbit = (lo >> U(28)) & U(1)
    sticky = (lo & U(0x0FFFFFFF)) != U(0)
    inc = (rbit != U(0)) & (sticky | ((m24 & U(1)) != U(0)))
    m24 = m24 + jnp.where(inc, U(1), U(0))
    ovf = m24 == U(0x1000000)
    m24 = jnp.where(ovf, U(0x800000), m24)
    e32 = e - I(896) + jnp.where(ovf, I(1), I(0))
    out = sign | (e32.astype(U) << U(23)) | (m24 & U(0x7FFFFF))
    return jnp.where(is_zero, sign, out)


# --------------------------------------------------------------------------
# exact 106-bit product and the rounded/fused operations
# --------------------------------------------------------------------------

def _limbs4(mw):
    """53-bit mantissa words [lo, hi21] -> four 16-bit limbs (u32)."""
    lo, hi = mw
    return [lo & U(0xFFFF), lo >> U(16), hi & U(0xFFFF), hi >> U(16)]


def _mul_exact(a, b):
    """Exact product of two binary64 values (normal/zero).

    Returns (P words[4] (128-bit), E = ea + eb int32, sign_bool,
    is_zero).  P in [2^104, 2^106) when nonzero."""
    sa, ea, ma, za = _unpack64(*a)
    sb, eb, mb, zb = _unpack64(*b)
    al = _limbs4(ma)
    bl = _limbs4(mb)
    # column sums of 16-bit partial products (each pij < 2^32; its two
    # 16-bit halves go to columns k and k+1; column sums stay < 2^23)
    cols = [jnp.zeros(a[0].shape, U) for _ in range(9)]
    for i in range(4):
        for j in range(4):
            p = al[i] * bl[j]
            cols[i + j] = cols[i + j] + (p & U(0xFFFF))
            cols[i + j + 1] = cols[i + j + 1] + (p >> U(16))
    # carry-propagate into 16-bit limbs, then pack into 4 words
    limbs = []
    carry = jnp.zeros(a[0].shape, U)
    for c in cols[:8]:
        t = c + carry
        limbs.append(t & U(0xFFFF))
        carry = t >> U(16)
    P = [limbs[2 * i] | (limbs[2 * i + 1] << U(16)) for i in range(4)]
    return P, ea + eb, sa ^ sb, za | zb


def mul64(a, b):
    """Correctly-rounded binary64 multiply."""
    P, E, sgn, is_zero = _mul_exact(a, b)
    hi, lo = _round53(P, E - I(104), sgn, jnp.zeros(P[0].shape, U))
    hi = jnp.where(is_zero, U(0), hi)
    lo = jnp.where(is_zero, U(0), lo)
    return hi, lo


def fma64(a, b, c):
    """Correctly-rounded fused multiply-add a*b + c (normal range)."""
    P, E, sp, pz = _mul_exact(a, b)
    sc, ec, mc, cz = _unpack64(*c)
    shape = P[0].shape
    zero6 = [jnp.zeros(shape, U) for _ in range(6)]

    # window: 192 bits, top exponent E_top = max(E, ec) + 2
    E_top = jnp.maximum(E, ec) + I(2)
    sp_sh = E + I(87) - E_top            # product shift, in [30, 85]
    sa_sh = ec + I(139) - E_top          # addend shift (may be < 0)
    Pw = _wshl(P + [zero6[0], zero6[0]], jnp.maximum(sp_sh, I(0)), 6)
    c2 = [mc[0], mc[1], zero6[0], zero6[0], zero6[0], zero6[0]]
    Cl = _wshl(c2, jnp.maximum(sa_sh, I(0)), 6)
    Cr, st_c = _wshr_sticky(mc + [zero6[0]] * 4,
                            jnp.maximum(-sa_sh, I(0)))
    neg = sa_sh < I(0)
    Cw = [jnp.where(neg, r, l) for r, l in zip(Cr, Cl)]
    sticky = jnp.where(neg, st_c, U(0))
    sticky = jnp.where(cz, U(0), sticky)
    Cw = [jnp.where(cz, U(0), w) for w in Cw]

    same = ~(sp ^ sc)
    # same sign: plain add.  opposite: big minus small; when the addend
    # carries sticky (it sits far below the product) the true value is
    # (P - C) minus a sub-lsb fraction: represent as (P - C - 1) + sticky
    Vadd = _wadd(Pw, Cw)
    c_big = _wlt(Pw, Cw)
    Vs1 = _wsub(Pw, Cw)
    one6 = [jnp.ones(shape, U)] + [zero6[0]] * 5
    Vs1m = _wsub(Vs1, one6)
    stick_adj = (~same) & (sticky != U(0))
    Vsub_pc = [jnp.where(stick_adj, m, s) for m, s in zip(Vs1m, Vs1)]
    Vsub_cp = _wsub(Cw, Pw)
    V = [jnp.where(same, av, jnp.where(c_big, cv, pv))
         for av, cv, pv in zip(Vadd, Vsub_cp, Vsub_pc)]
    sign = jnp.where(same, sp, jnp.where(c_big, sc, sp))

    hi, lo = _round53(V, E_top - I(191), sign, sticky)

    # far addend: product entirely below c's rounding influence -> c
    far_c = (ec - E) >= I(56)
    hi = jnp.where(far_c, c[0], hi)
    lo = jnp.where(far_c, c[1], lo)
    # degenerate operands
    hi = jnp.where(pz, c[0], hi)
    lo = jnp.where(pz, c[1], lo)
    rhi, rlo = _round53(P, E - I(104), sp, jnp.zeros(shape, U))
    hi = jnp.where(cz & ~pz, rhi, hi)
    lo = jnp.where(cz & ~pz, rlo, lo)
    return hi, lo


# --------------------------------------------------------------------------
# glibc 2.36 __expf_fma replica
# --------------------------------------------------------------------------

def _k64(x: float):
    import struct
    b = struct.unpack("<Q", struct.pack("<d", x))[0]
    return U(b >> 32), U(b & 0xFFFFFFFF)


# constant pool extracted from libm.so.6 rodata (addresses ade40-ade80),
# byte-verified against the mapped library on this machine
_INVLN2N = float.fromhex("0x1.71547652b82fep+5")
_C0 = float.fromhex("0x1.c6af84b912394p-20")
_C1 = float.fromhex("0x1.ebfce50fac4f3p-13")
_C2 = float.fromhex("0x1.62e42ff0c52d6p-6")
_ONE = 1.0

# tab[i] = bits(2^(i/32)) - (i << 47), extracted from rodata at 0xadd40
# and verified equal to that expression for this libm build
_TAB = [
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540,
]
_TAB_HI = jnp.asarray([t >> 32 for t in _TAB], jnp.uint32)
_TAB_LO = jnp.asarray([t & 0xFFFFFFFF for t in _TAB], jnp.uint32)


def expf_bits(bits):
    """Bit-exact glibc 2.36 __expf_fma over its main path (|x| < 88,
    normal or subnormal x, result a normal f32).

    The asm sequence being replicated (disassembly at 0x72ba0):
      z+S = fma(InvLn2N, xd, SHIFT); ki = asuint64; kd = (z+S) - SHIFT
      r   = fma(InvLn2N, xd, -kd)
      s   = asdouble(tab[ki % 32] + (ki << 47))
      z2 = fma(C0, r, C1); r2 = r*r; y = fma(C2, r, 1)
      y  = fma(z2, r2, y); y = y * s;  result = (float)y
    The first two fmas are folded into exact integer arithmetic on the
    one 106-bit product z = InvLn2N * xd (the SHIFT trick is literally
    round-half-even-to-int, and r is the rounded difference z - k, both
    computable from the product limbs without a general fma)."""
    shape = bits.shape
    xd = f32_to_f64(bits)
    inv = _k64(_INVLN2N)
    P, E, sgn, is_zero = _mul_exact((jnp.broadcast_to(inv[0], shape),
                                     jnp.broadcast_to(inv[1], shape)), xd)

    # k = round-half-even-to-int(z) from the product limbs; |z| < 2^13
    j0 = I(104) - E                       # bit position of 2^0 in P
    j0c = jnp.minimum(jnp.maximum(j0, I(0)), I(127))
    ip_w, _ = _wshr_sticky(P, j0c)
    ip = ip_w[0]                          # integer part, < 2^13
    rb_w, st_low = _wshr_sticky(P, jnp.maximum(j0c - I(1), I(0)))
    rbit = rb_w[0] & U(1)
    inc = (rbit != U(0)) & ((st_low != U(0)) | ((ip & U(1)) != U(0)))
    kmag = ip + jnp.where(inc, U(1), U(0))
    k = jnp.where(sgn, -(kmag.astype(I)), kmag.astype(I))
    k = jnp.where(is_zero, I(0), k)

    # r = fl64(z - k): exact subtract in the product frame, then round
    K = _wshl([kmag] + [jnp.zeros(shape, U)] * 3, j0c, 4)
    k_big = _wlt(P, K)
    D = [jnp.where(k_big, a, b) for a, b in zip(_wsub(K, P), _wsub(P, K))]
    r_sign = sgn ^ k_big
    r = _round53(D, E - I(104), r_sign, jnp.zeros(shape, U))
    r = (jnp.where(is_zero, U(0), r[0]), jnp.where(is_zero, U(0), r[1]))

    # s = asdouble(tab[k % 32] + (k << 47)): low words never interact
    idx = (k & I(31)).astype(U)
    t_hi = jnp.take(_TAB_HI, idx) + ((k & I(0x1FFFF)).astype(U) << U(15))
    t_lo = jnp.take(_TAB_LO, idx)
    s64 = (t_hi, t_lo)

    def bc(kpair):
        return (jnp.broadcast_to(kpair[0], shape),
                jnp.broadcast_to(kpair[1], shape))

    z2 = fma64(bc(_k64(_C0)), r, bc(_k64(_C1)))
    r2 = mul64(r, r)
    y = fma64(bc(_k64(_C2)), r, bc(_k64(_ONE)))
    y = fma64(z2, r2, y)
    y = mul64(y, s64)
    return f64_to_f32(*y)


def expf32(x):
    """Bit-exact libm expf on a float32 array (main-path domain)."""
    return bits_f32(expf_bits(f32_bits(x)))


# --------------------------------------------------------------------------
# correctly-rounded f32 divide and sqrt (integer-corrected)
# --------------------------------------------------------------------------

def _mul_24x27(a, b):
    """Exact product of a (<2^27) and b (<2^25) as 2 words."""
    a0, a1 = a & U(0xFFFF), a >> U(16)
    b0, b1 = b & U(0xFFFF), b >> U(16)
    lo = a0 * b0
    mid = a1 * b0 + a0 * b1          # < 2^28, no overflow
    hi = a1 * b1
    m_lo = mid << U(16)
    lo2 = lo + m_lo
    carry = jnp.where(lo2 < lo, U(1), U(0))
    return [lo2, hi + (mid >> U(16)) + carry]


def _unpack32(bits):
    sign = bits & U(0x80000000)
    e = ((bits >> U(23)) & U(0xFF)).astype(I)
    m = bits & U(0x7FFFFF)
    is_zero = (bits & U(0x7FFFFFFF)) == U(0)
    # normalize subnormals into (m24 in [2^23, 2^24), e_unb)
    sub = e == I(0)
    eb = _ilog2(m)
    m_n = m | U(0x800000)
    sh = (I(23) - eb).astype(U)
    m_s = m << jnp.minimum(sh, U(23))
    m24 = jnp.where(sub, m_s, m_n)
    e_unb = jnp.where(sub, eb - I(149), e - I(127))
    return sign, e_unb, m24, is_zero


def div32(a_bits, b_bits):
    """fl32(a / b), correctly rounded (normal/subnormal inputs, normal
    quotient).  b must be nonzero; a may be zero."""
    sa, ea, ma, za = _unpack32(a_bits)
    sb, eb, mb, _ = _unpack32(b_bits)
    sign = sa ^ sb

    # q = floor((ma << 26) / mb) in (2^25, 2^27); a float estimate is
    # snapped to the true floor by exact-integer remainder correction
    # (device f32 divide is a few ulp off; worst-case estimate error
    # after the coarse step is ~2^6, the fine step leaves <= 2)
    est = (ma.astype(jnp.float32) / mb.astype(jnp.float32)
           * jnp.float32(1 << 26))
    q = jnp.minimum(est, jnp.float32(1 << 27)).astype(U)
    N = [ma << U(26), ma >> U(6)]        # ma * 2^26, 50 bits
    # coarse correction: adj ~= (N - q*mb) / mb via float, exact update
    QB = _mul_24x27(q, mb)
    q_high = _wlt(N, QB)
    R = _wsub(QB, N)
    R2 = _wsub(N, QB)
    R = [jnp.where(q_high, a, b) for a, b in zip(R, R2)]
    rf = R[0].astype(jnp.float32) + R[1].astype(jnp.float32) \
        * jnp.float32(4294967296.0)
    adj = (rf / mb.astype(jnp.float32)).astype(U)
    q = jnp.where(q_high, q - adj, q + adj)
    # fine correction: at most a couple of +-1 steps remain
    for _ in range(3):
        QB = _mul_24x27(q, mb)
        under = _wlt(N, QB)              # q too big
        q = jnp.where(under, q - U(1), q)
    for _ in range(3):
        QB = _mul_24x27(q + U(1), mb)
        over = ~_wlt(N, QB)              # (q+1)*mb <= N -> q too small
        q = jnp.where(over, q + U(1), q)
    QB = _mul_24x27(q, mb)
    rem_nz = ~((QB[0] == N[0]) & (QB[1] == N[1]))

    big = q >= U(1 << 26)                # quotient in [1, 2)
    # big: mant bits = q >> 3 (24 incl implicit), round = bit2, sticky low
    # small: q in [2^25, 2^26): mant = q >> 2, round = bit1
    mant = jnp.where(big, q >> U(3), q >> U(2))
    rbit = jnp.where(big, (q >> U(2)) & U(1), (q >> U(1)) & U(1))
    stick = jnp.where(big, (q & U(3)) != U(0), (q & U(1)) != U(0)) | rem_nz
    inc = (rbit != U(0)) & (stick | ((mant & U(1)) != U(0)))
    mant = mant + jnp.where(inc, U(1), U(0))
    ovf = mant == U(0x1000000)
    mant = jnp.where(ovf, U(0x800000), mant)
    e_res = ea - eb + jnp.where(big, I(0), I(-1)) + jnp.where(ovf, I(1),
                                                              I(0))
    out = sign | ((e_res + I(127)).astype(U) << U(23)) | (mant & U(0x7FFFFF))
    return jnp.where(za, sa, out)


def sqrt32(v_bits):
    """fl32(sqrt(v)), correctly rounded; v >= 0, result normal or zero."""
    _, e_unb, m24, is_zero = _unpack32(v_bits)
    # value = m24 * 2^Ev; force Ev even so sqrt factors cleanly
    Ev = e_unb - I(23)
    odd = (Ev & I(1)) != I(0)
    mp = jnp.where(odd, m24 << U(1), m24)          # in [2^23, 2^25)
    E2 = jnp.where(odd, Ev - I(1), Ev)             # even
    # M = mp << 24 (47..49 bits); r = floor(sqrt(M)) in (2^23, 2^24.5);
    # sqrt(v) = sqrt(M) * 2^(E2/2 - 12)
    M = [mp << U(24), mp >> U(8)]
    est = jnp.sqrt(mp.astype(jnp.float32) * jnp.float32(1 << 24))
    r = jnp.minimum(est, jnp.float32((1 << 25) - 1)).astype(U)
    for _ in range(16):
        RR = _mul_24x27(r, r)
        over = _wlt(M, RR)
        r = jnp.where(over, r - U(1), r)
    for _ in range(16):
        r1 = r + U(1)
        RR = _mul_24x27(r1, r1)
        under = ~_wlt(M, RR)
        r = jnp.where(under, r1, r)
    RR = _mul_24x27(r, r)
    exact = (RR[0] == M[0]) & (RR[1] == M[1])

    big = r >= U(1 << 24)                # 25-bit root: mant = r >> 1
    mant = jnp.where(big, r >> U(1), r)
    # sqrt(M) = r + f, f in [0, 1).
    # 24-bit case: round up iff f > 0.5 iff (2r+1)^2 < 4M (ties cannot
    # occur: (2r+1)^2 is odd, 4M even).
    tr = (r << U(1)) | U(1)
    TT = _mul_24x27(tr, tr)              # (2r+1)^2, <= 51 bits
    M4 = [M[0] << U(2), (M[1] << U(2)) | (M[0] >> U(30))]
    up_small = _wlt(TT, M4)
    # 25-bit case: dropped = (r&1) + f vs half-ulp 1: r even -> down;
    # r odd & f>0 -> up; r odd & f==0 -> tie, round to even mantissa
    rb = (r & U(1)) != U(0)
    inc = jnp.where(big, rb & (~exact | ((mant & U(1)) != U(0))),
                    up_small)
    mant = mant + jnp.where(inc, U(1), U(0))
    ovf = mant == U(0x1000000)
    mant = jnp.where(ovf, U(0x800000), mant)
    # r in [2^23, 2^24): e_res = E2/2 + 11; 25-bit r: one higher
    e_res = (E2 >> 1) + I(11) + jnp.where(big, I(1), I(0)) \
        + jnp.where(ovf, I(1), I(0))
    out = ((e_res + I(127)).astype(U) << U(23)) | (mant & U(0x7FFFFF))
    return jnp.where(is_zero, U(0), out)
