"""Finite-field arithmetic GF(p^n) for the Galois constructions in the paper.

Slim Fly / MMS graphs (paper Ex. 2.4.2), Paley graphs QR(q) (App. B.1) and the
Erdos-Renyi polarity graph ER_q (App. B.7) all need GF(q) arithmetic for prime
powers q.  Elements are represented as integers in [0, q) encoding polynomial
coefficients base p;  add/mul tables are precomputed (q is small: <= a few
hundred for every topology we instantiate).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

# Irreducible (Conway-ish) polynomials over GF(p), as coefficient tuples of
# x^n = -(c_0 + c_1 x + ... + c_{n-1} x^{n-1}); stored lowest degree first.
_IRREDUCIBLE = {
    (2, 2): (1, 1),        # x^2 + x + 1
    (2, 3): (1, 1, 0),     # x^3 + x + 1
    (2, 4): (1, 1, 0, 0),  # x^4 + x + 1
    (2, 5): (1, 0, 1, 0, 0),
    (3, 2): (1, 2),        # x^2 + 2x + 1? no: x^2 = -(1 + 2x) = 2 + x  -> x^2+2x+1 reducible; use x^2+1? p=3: x^2+1 irreducible
    (5, 2): (2, 4),
    (7, 2): (3, 6),
}
# Fix (3,2): x^2 + 1 is irreducible mod 3 (since -1 is not a QR mod 3).
_IRREDUCIBLE[(3, 2)] = (1, 0)
# (5,2): x^2 + 2 irreducible mod 5 (2 is a non-residue mod 5).
_IRREDUCIBLE[(5, 2)] = (2, 0)
# (7,2): x^2 + 1 irreducible mod 7 (-1 non-residue since 7 % 4 == 3).
_IRREDUCIBLE[(7, 2)] = (1, 0)


def _factor_prime_power(q: int) -> tuple[int, int]:
    for p in range(2, q + 1):
        if q % p == 0:
            n = 0
            m = q
            while m % p == 0:
                m //= p
                n += 1
            if m != 1:
                raise ValueError(f"{q} is not a prime power")
            return p, n
    raise ValueError(f"{q} is not a prime power")


@dataclass(frozen=True)
class GF:
    """GF(q) with integer-encoded elements and precomputed tables."""

    q: int
    p: int
    n: int
    add_table: tuple  # add_table[a][b]
    mul_table: tuple
    neg_table: tuple
    inv_table: tuple  # inv_table[a] for a != 0 (inv_table[0] = 0 sentinel)
    primitive: int    # a generator of GF(q)*

    # -- arithmetic ---------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return self.add_table[a][b]

    def sub(self, a: int, b: int) -> int:
        return self.add_table[a][self.neg_table[b]]

    def mul(self, a: int, b: int) -> int:
        return self.mul_table[a][b]

    def neg(self, a: int) -> int:
        return self.neg_table[a]

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("inverse of 0 in GF(q)")
        return self.inv_table[a]

    def div(self, a: int, b: int) -> int:
        return self.mul(a, self.inv(b))

    def pow(self, a: int, e: int) -> int:
        out, base = 1, a
        e = int(e)
        if e < 0:
            base, e = self.inv(a), -e
        while e:
            if e & 1:
                out = self.mul(out, base)
            base = self.mul(base, base)
            e >>= 1
        return out

    # -- derived sets --------------------------------------------------------
    def quadratic_residues(self) -> set[int]:
        """Nonzero squares of GF(q)."""
        return {self.mul(a, a) for a in range(1, self.q)}

    def elements(self) -> range:
        return range(self.q)


def _poly_mul_mod(a: int, b: int, p: int, n: int, red: tuple) -> int:
    """Multiply base-p encoded polynomials mod the irreducible polynomial."""
    # decode
    ca = [(a // p**i) % p for i in range(n)]
    cb = [(b // p**i) % p for i in range(n)]
    prod = [0] * (2 * n - 1)
    for i, x in enumerate(ca):
        if x:
            for j, y in enumerate(cb):
                prod[i + j] = (prod[i + j] + x * y) % p
    # reduce: x^n = -(red[0] + red[1] x + ...)
    for d in range(2 * n - 2, n - 1, -1):
        c = prod[d]
        if c:
            prod[d] = 0
            for j, r in enumerate(red):
                prod[d - n + j] = (prod[d - n + j] - c * r) % p
    return sum(c * p**i for i, c in enumerate(prod[:n]))


@functools.lru_cache(maxsize=None)
def gf(q: int) -> GF:
    """Build (and cache) GF(q) for prime power q."""
    p, n = _factor_prime_power(q)
    if n == 1:
        add = tuple(tuple((a + b) % p for b in range(p)) for a in range(p))
        mul = tuple(tuple((a * b) % p for b in range(p)) for a in range(p))
    else:
        red = _IRREDUCIBLE.get((p, n))
        if red is None:
            red = _find_irreducible(p, n)
        def padd(a, b):
            return sum((((a // p**i) % p + (b // p**i) % p) % p) * p**i
                       for i in range(n))
        add = tuple(tuple(padd(a, b) for b in range(q)) for a in range(q))
        mul = tuple(tuple(_poly_mul_mod(a, b, p, n, red) for b in range(q))
                    for a in range(q))
    neg = tuple(next(b for b in range(q) if add[a][b] == 0) for a in range(q))
    inv = [0] * q
    for a in range(1, q):
        inv[a] = next(b for b in range(1, q) if mul[a][b] == 1)
    # find a primitive element
    primitive = None
    for g in range(2, q):
        seen, x = set(), 1
        for _ in range(q - 1):
            x = mul[x][g]
            seen.add(x)
        if len(seen) == q - 1:
            primitive = g
            break
    if primitive is None:  # q == 2
        primitive = 1
    return GF(q, p, n, add, mul, neg, tuple(inv), primitive)


def _find_irreducible(p: int, n: int) -> tuple:
    """Brute-force search for a degree-n irreducible polynomial over GF(p)."""
    import itertools

    def eval_mod(coeffs, x):  # coeffs lowest-first of monic poly of degree n
        # value of x^n + sum coeffs[i] x^i  mod p  ... need full poly division
        raise NotImplementedError

    # Try all monic polynomials; test irreducibility by having no roots is
    # insufficient for n >= 4, so do trial division by all monic polys of
    # degree <= n//2 (coefficients in small p, fine for table sizes).
    def poly_mod(num, den):
        num = list(num)
        dn = len(den) - 1
        while len(num) - 1 >= dn and any(num):
            shift = len(num) - 1 - dn
            c = num[-1]
            if c:
                for i, d in enumerate(den):
                    num[shift + i] = (num[shift + i] - c * d) % p
            num.pop()
        while num and num[-1] == 0:
            num.pop()
        return num

    for tail in itertools.product(range(p), repeat=n):
        cand = list(tail) + [1]  # monic degree n
        if cand[0] == 0:
            continue
        irreducible = True
        for deg in range(1, n // 2 + 1):
            for dtail in itertools.product(range(p), repeat=deg):
                den = list(dtail) + [1]
                if not poly_mod(cand, den):
                    irreducible = False
                    break
            if not irreducible:
                break
        if irreducible:
            return tuple(cand[:n])
    raise RuntimeError(f"no irreducible polynomial found for GF({p}^{n})")
