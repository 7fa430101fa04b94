"""Pure-Python BN254 (alt_bn128) ground truth: fields, curves, pairing.

Role in the framework (mirrors what arkworks provides to the reference —
SURVEY.md §0 "ark-ff/ark-ec"): host-side verifier algebra (pairing product
checks for PST13), trusted-setup generation, and the bit-exactness oracle the
TPU limb kernels are tested against. Everything here is Python ints — it is
deliberately NOT on the prover's hot path.

Attribution: the tower-field arithmetic (extended-Euclid inverse over
polynomial bases, poly_rounded_div) and the optimal-ate pairing structure
(linefunc, Miller loop, twist lift) are derived from the Ethereum
Foundation's public ``py_ecc`` library (github.com/ethereum/py_ecc,
MIT license), adapted to this module's coefficient-tuple representation.
It is NOT derived from the reference implementation (which uses arkworks).

Implementation: standard affine Weierstrass arithmetic over a polynomial-basis
tower (FQ2 = FQ[i]/(i^2+1), FQ12 = FQ[w]/(w^12 - 18 w^6 + 82)) and the
optimal-ate Miller loop with points lifted to FQ12 via the sextic twist.
"""

from __future__ import annotations

from .field import FR_MODULUS, FQ_MODULUS

P = FQ_MODULUS
R_ORDER = FR_MODULUS

# --- generic tower field (polynomial basis) --------------------------------


class PolyExtField:
    """Element of FQ[x]/(modulus_coeffs), coefficients are ints mod P."""

    degree = 0
    modulus_coeffs: tuple = ()

    __slots__ = ("coeffs",)

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = tuple(c % P for c in coeffs)

    @classmethod
    def one(cls):
        return cls((1,) + (0,) * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls((0,) * cls.degree)

    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __mul__(self, other):
        d = self.degree
        if isinstance(other, int):
            return type(self)([a * other for a in self.coeffs])
        b = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                for j, c in enumerate(other.coeffs):
                    b[i + j] += a * c
        # reduce by monic modulus poly
        for i in range(2 * d - 2, d - 1, -1):
            top = b[i] % P
            if top:
                for j, mc in enumerate(self.modulus_coeffs):
                    b[i - d + j] -= top * mc
            b[i] = 0
        return type(self)(b[:d])

    __rmul__ = __mul__

    def __pow__(self, e):
        result = type(self).one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        # extended Euclid over FQ[x]
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = list(self.coeffs) + [0]
        high = list(self.modulus_coeffs) + [1]

        def deg(poly):
            for i in range(len(poly) - 1, -1, -1):
                if poly[i] % P:
                    return i
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = [x for x in a]
            o = [0] * len(a)
            binv = pow(b[degb], -1, P)
            for i in range(dega - degb, -1, -1):
                o[i] = (o[i] + temp[degb + i] * binv) % P
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - o[i] * b[c]) % P
            return [x % P for x in o[: deg(o) + 1]]

        while deg(low):
            rq = poly_rounded_div(high, low)
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    if i < len(rq):
                        nm[i + j] -= lm[j] * rq[i]
                        new[i + j] -= low[j] * rq[i]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        c0inv = pow(low[0], -1, P)
        return type(self)([(c * c0inv) % P for c in lm[:d]])

    def __truediv__(self, other):
        if isinstance(other, int):
            return self * pow(other, -1, P)
        return self * other.inv()

    def __eq__(self, other):
        return type(self) is type(other) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash(self.coeffs)

    def is_zero(self):
        return all(c == 0 for c in self.coeffs)

    def __repr__(self):
        return f"{type(self).__name__}{self.coeffs}"


class FQ2(PolyExtField):
    degree = 2
    modulus_coeffs = (1, 0)  # i^2 = -1


class FQ12(PolyExtField):
    degree = 12
    modulus_coeffs = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)  # w^12 = 18w^6 - 82


class FQ1(PolyExtField):
    """Degree-1 wrapper so curve ops are generic over the tower."""

    degree = 1
    modulus_coeffs = (1,)  # unused

    def __mul__(self, other):
        if isinstance(other, int):
            return FQ1((self.coeffs[0] * other,))
        return FQ1((self.coeffs[0] * other.coeffs[0],))

    __rmul__ = __mul__

    def inv(self):
        return FQ1((pow(self.coeffs[0], -1, P),))


# --- curves ----------------------------------------------------------------

# Points are affine (x, y) tuples or None for infinity.

B1 = FQ1((3,))
B2 = FQ2((3, 0)) / FQ2((9, 1))  # 3 / (9 + i)

G1_GEN = (FQ1((1,)), FQ1((2,)))
G2_GEN = (
    FQ2((
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    )),
    FQ2((
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    )),
)


def is_on_curve(pt, b):
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x) == b


def double(pt):
    if pt is None:
        return None
    x, y = pt
    if y.is_zero():
        return None
    m = (3 * (x * x)) / (2 * y)
    newx = m * m - 2 * x
    newy = m * (x - newx) - y
    return (newx, newy)


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return double(p1)
    if x1 == x2:
        return None
    m = (y2 - y1) / (x2 - x1)
    newx = m * m - x1 - x2
    newy = m * (x1 - newx) - y1
    return (newx, newy)


def neg_pt(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, -y)


def scalar_mul(pt, n):
    n %= R_ORDER
    result = None
    base = pt
    while n:
        if n & 1:
            result = add(result, base)
        base = double(base)
        n >>= 1
    return result


def msm(points, scalars):
    acc = None
    for pt, s in zip(points, scalars):
        acc = add(acc, scalar_mul(pt, s))
    return acc


# --- pairing ---------------------------------------------------------------

ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE_LOOP_COUNT = 63

W = FQ12((0, 1) + (0,) * 10)
W2 = W * W
W3 = W2 * W


def twist(pt):
    """Lift a G2 point (FQ2 coords) onto the curve over FQ12."""
    if pt is None:
        return None
    x, y = pt
    xc = (x.coeffs[0] - 9 * x.coeffs[1], x.coeffs[1])
    yc = (y.coeffs[0] - 9 * y.coeffs[1], y.coeffs[1])
    nx = FQ12((xc[0], 0, 0, 0, 0, 0, xc[1], 0, 0, 0, 0, 0))
    ny = FQ12((yc[0], 0, 0, 0, 0, 0, yc[1], 0, 0, 0, 0, 0))
    return (nx * W2, ny * W3)


def cast_g1_to_fq12(pt):
    if pt is None:
        return None
    x, y = pt
    return (
        FQ12((x.coeffs[0],) + (0,) * 11),
        FQ12((y.coeffs[0],) + (0,) * 11),
    )


def linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    elif y1 == y2:
        m = 3 * (x1 * x1) / (2 * y1)
        return m * (xt - x1) - (yt - y1)
    else:
        return xt - x1


def miller_loop(q_g2, p_g1):
    """Miller loop contribution for one (G2, G1) pair — final exp NOT applied.

    Inputs are affine points on G2 (FQ2 coords) and G1 (FQ1 coords).
    """
    if q_g2 is None or p_g1 is None:
        return FQ12.one()
    q = twist(q_g2)
    pt = cast_g1_to_fq12(p_g1)
    r = q
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * linefunc(r, r, pt)
        r = double(r)
        if ATE_LOOP_COUNT & (2 ** i):
            f = f * linefunc(r, q, pt)
            r = add(r, q)
    q1 = (q[0] ** P, q[1] ** P)
    nq2 = (q1[0] ** P, -(q1[1] ** P))
    f = f * linefunc(r, q1, pt)
    r = add(r, q1)
    f = f * linefunc(r, nq2, pt)
    return f


FINAL_EXP = (P ** 12 - 1) // R_ORDER


def final_exponentiation(f):
    return f ** FINAL_EXP


def pairing(q_g2, p_g1):
    return final_exponentiation(miller_loop(q_g2, p_g1))


def multi_pairing_is_one(pairs):
    """Check prod e(P_i, Q_i) == 1 with a single shared final exponentiation.

    ``pairs``: iterable of (g1_point, g2_point). Pure Python: the port keeps
    no native verifier, so this is the whole path.
    """
    return multi_pairing_is_one_py(pairs)


def multi_pairing_is_one_py(pairs):
    """Pure-Python pairing product check (the ground-truth path)."""
    acc = FQ12.one()
    for p_g1, q_g2 in pairs:
        acc = acc * miller_loop(q_g2, p_g1)
    return final_exponentiation(acc) == FQ12.one()


# --- convenience constructors ----------------------------------------------


def g1(x: int, y: int):
    return (FQ1((x,)), FQ1((y,)))


def g1_coords(pt):
    """Affine G1 point -> (x, y) ints; None -> (0, 0) (our infinity encoding)."""
    if pt is None:
        return (0, 0)
    return (pt[0].coeffs[0], pt[1].coeffs[0])


def g1_from_coords(xy):
    x, y = xy
    if x == 0 and y == 0:
        return None
    return g1(x, y)
