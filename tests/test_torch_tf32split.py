"""The precision argument of the 3xTF32 products, on the CPU.

K3/K4's big body (phyml_tpu_torch/csrc/big.cuh) runs every product of
the pruning pass on the tensor cores in TF32 (10 mantissa bits), split
in three: each float32 operand x becomes hi = tf32(x) and lo = tf32(x -
hi), and a product sums A_lo B_hi, A_hi B_lo and A_hi B_hi in three
float32 accumulators of mma.sync.m16n8k8.  This emulates that walk in
numpy: the split rounding to 10 mantissa bits with ties to even, and as
the kernels round (csrc/big.cuh: tf32_split adds half a TF32 ulp to the
bits, ties away from zero, and the tensor cores read the top 19 bits);
each mma's k-step as the tensor cores add, the exact sum of its 8
products truncated to float32 (round toward zero), then added to the
accumulator and truncated again.  On P(t) matrices at 80 and 160 states
and on partials whose columns span many binary orders (as the rescaled
partials do), from a numpy seed, against float64:

* the emulated walk's error, relative to |A| |X| (the usual bound of a
  float32 dot product's rounding), is within 4 times that of a float32
  matmul of the same operands, and below 2^-18 (NS = 160 terms of
  float32 rounding, 2^-24 each, are ~2^-16.7 at worst);
* one TF32 pass alone (A_hi B_hi) is at least 100 times worse: the
  dropped terms are why the kernels take three.

K5's eigen-basis products V^T o and V^-1 x are a different case
(test_eigen_basis_terms_follow_the_order_of_the_sums): their terms
cancel, so any two float32 sums that round apart, each as accurate as
float32, differ in the edge terms by about float32's own error there.
K5 (csrc/big_ffma.cuh) therefore sums in the plain version's order.
"""

import numpy as np
import pytest
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), ties to even."""
    b = x.contiguous().view(torch.int32)
    odd = (b >> 13) & 1
    return ((b + 0x0FFF + odd) & ~0x1FFF).view(torch.float32)


def tf32_away(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 as the kernels do: half a TF32 ulp added
    to the bits (ties away from zero), the low 13 bits then dropped (the
    tensor cores read the top 19 bits of a register)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split_away(x: torch.Tensor):
    """The kernels' split (csrc/big.cuh: tf32_split)."""
    hi = tf32_away(x)
    return hi, tf32_away(x - hi)


def split(x: torch.Tensor):
    """hi, lo: each rounded to TF32, ties to even."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def pmatrix(ns: int, t: float, rng) -> np.ndarray:
    """P(t) of a random reversible rate matrix with random frequencies,
    normalised to one substitution a unit of time (float64)."""
    pi = rng.dirichlet(np.ones(ns))
    s = rng.gamma(1.0, 1.0, size=(ns, ns))
    s = (s + s.T) / 2
    q = s * pi[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(1))
    q /= -(pi * np.diag(q)).sum()
    d = np.sqrt(pi)
    lam, u = np.linalg.eigh(d[:, None] * q / d[None, :])
    return (u / d[:, None]) @ np.diag(np.exp(lam * t)) @ (u.T * d[None, :])


def partials(ns: int, P: int, rng) -> np.ndarray:
    """Positive partials whose columns span ~40 binary orders, each
    column's maximum in [1, 2) (as the kernels' rescale leaves them)."""
    x = (1.0 + rng.random((ns, P))) * 2.0 ** -rng.integers(0, 40, (ns, P))
    return x / 2.0 ** np.floor(np.log2(x.max(0)))


def round_to_zero(v: np.ndarray) -> np.ndarray:
    """float64 v as float32, rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma_sum(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """A X (TF32 values) in one float32 accumulator of mma.m16n8k8: for
    each k-step of 8, the exact sum of its products truncated, then
    added to the accumulator and truncated."""
    a, x = a.astype(np.float64), x.astype(np.float64)
    acc = np.zeros((a.shape[0], x.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = round_to_zero(a[:, k:k + 8] @ x[k:k + 8])
        acc = round_to_zero(acc.astype(np.float64) + s)
    return acc


def product_3xtf32(a: torch.Tensor, x: torch.Tensor, how=split):
    """A X as K3/K4's walk takes it (csrc/big.cuh: big_walk): A_lo X_hi,
    A_hi X_lo and A_hi X_hi each in its own mma accumulator, then
    hi + (c1 + c2) in float32."""
    ah, al = (t.numpy() for t in how(a))
    xh, xl = (t.numpy() for t in how(x))
    hi, c1, c2 = mma_sum(ah, xh), mma_sum(al, xh), mma_sum(ah, xl)
    return torch.from_numpy(hi + (c1 + c2))


def product_ffma(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """A X in float32 with one FFMA a term, k in order (K5's walk,
    csrc/big_ffma.cuh, and a float32 GEMM without split sums)."""
    a64, x64 = a.astype(np.float64), x.astype(np.float64)
    acc = np.zeros((a.shape[0], x.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc.astype(np.float64) + a64[:, k:k + 1] * x64[k:k + 1]) \
            .astype(np.float32)
    return acc


def rel_err(got: torch.Tensor, a64, x64) -> float:
    ref = a64 @ x64
    scale = np.abs(a64) @ np.abs(x64)
    return float(np.max(np.abs(got.double().numpy() - ref) / scale))


@pytest.mark.parametrize("ns", [80, 160])
@pytest.mark.parametrize("t", [0.05, 1.0])
def test_3xtf32_product_keeps_float32_precision(ns, t):
    rng = np.random.default_rng(ns + int(100 * t))
    a32 = torch.tensor(pmatrix(ns, t, rng), dtype=torch.float32)
    for x in (partials(ns, 256, rng),
              # tip rows: 0/1 columns (a state, some ambiguous), lo zero
              np.maximum(np.eye(ns)[rng.integers(0, ns, 256)].T,
                         rng.random((ns, 256)) < 0.05)):
        x32 = torch.tensor(x, dtype=torch.float32)
        a64, x64 = a32.double().numpy(), x32.double().numpy()
        err_f32 = rel_err(a32 @ x32, a64, x64)
        err_1x = rel_err(tf32(a32) @ tf32(x32), a64, x64)
        for how in (split, split_away):
            err_3x = rel_err(product_3xtf32(a32, x32, how), a64, x64)
            assert err_3x <= 4 * max(err_f32, 2.0 ** -24), (err_3x, err_f32)
            assert err_3x < 2.0 ** -18
            assert err_1x >= 100 * err_3x, (err_1x, err_3x)


def test_tf32_rounding():
    """tf32 keeps 10 mantissa bits and rounds to nearest with ties to
    even (tf32_away: ties away from zero); either split gives TF32 halves
    exact to 2^-22 of x."""
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, 1.0 + 1.5 * ulp, 1.0 + 0.7 * ulp,
                      -(1.0 + 1.5 * ulp), 3.0e-30], dtype=torch.float32)
    assert tf32(x)[:4].tolist() == [1.0, 1.0 + 2 * ulp, 1.0 + ulp,
                                    -(1.0 + 2 * ulp)]
    assert tf32_away(x)[:4].tolist() == [1.0 + ulp, 1.0 + 2 * ulp,
                                         1.0 + ulp, -(1.0 + 2 * ulp)]
    assert tf32(one).item() == 1.0 == tf32_away(one).item()
    rng = np.random.default_rng(0)
    v = torch.tensor((rng.random(10000) - 0.5)
                     * 2.0 ** rng.integers(-60, 60, 10000),
                     dtype=torch.float32)
    for how, bound in ((split, 2.0 ** -22), (split_away, 2.0 ** -22)):
        hi, lo = how(v)
        assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
        assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
        gap = ((hi.double() + lo.double()) - v.double()).abs() \
            / v.double().abs()
        assert float(gap.max()) <= bound


def eigen_system(ns: int, rng):
    """(lambda, V, V^-1, pi) of a random reversible rate matrix whose
    frequencies are skewed (Dirichlet(0.2), each at least 1e-6), as in a
    covarion alphabet's rare states: V = U / sqrt(pi) has large entries
    of both signs, so V^T o and V^-1 x cancel."""
    pi = np.maximum(rng.dirichlet(0.2 * np.ones(ns)), 1e-6)
    pi /= pi.sum()
    s = rng.gamma(1.0, 1.0, size=(ns, ns))
    q = (s + s.T) / 2 * pi[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(1))
    q /= -(pi * np.diag(q)).sum()
    d = np.sqrt(pi)
    lam, u = np.linalg.eigh(d[:, None] * q / d[None, :])
    return lam, u / d[:, None], u.T * d[None, :], pi


@pytest.mark.parametrize("ns", [80, 160])
def test_eigen_basis_terms_follow_the_order_of_the_sums(ns):
    """An edge's site terms log sum_k (V^T o)_k (V^-1 x)_k e^(lambda_k t)
    (o an outside partial, x tip rows, t = 0.1) from the eigen-basis
    products taken three ways: in float64; by FFMA in order (K5's walk);
    by the emulated 3xTF32 walk of K3/K4.  Both float32 walks keep
    float32's accuracy (the 3xTF32 walk within 3 times the FFMA walk's
    error against float64), yet they stand apart by at least a quarter
    of that error, over 100 times the 2^-20 the P-products reach: a walk
    held to the plain version's float32 edge terms within a fixed
    tolerance has to sum in its order."""
    rng = np.random.default_rng(ns)
    lam, V, Vi, pi = eigen_system(ns, rng)
    vt = np.ascontiguousarray(V.T).astype(np.float32)
    vi = Vi.astype(np.float32)
    o = (partials(ns, 512, rng) * pi[:, None]).astype(np.float32)
    x = np.eye(ns, dtype=np.float32)[rng.integers(0, ns, 512)].T.copy()
    ex = np.exp(lam * 0.1)[:, None]

    def terms(prod):
        d = prod(vt, o).astype(np.float64) * prod(vi, x).astype(np.float64)
        return np.log(np.abs((d * ex).sum(0)))

    ref = terms(lambda a, b: a.astype(np.float64) @ b.astype(np.float64))
    ffma = terms(product_ffma)
    tc = terms(lambda a, b: product_3xtf32(
        torch.from_numpy(a), torch.from_numpy(b), split_away).numpy())
    err_ffma = float(np.abs(ffma - ref).max())
    err_tc = float(np.abs(tc - ref).max())
    gap = float(np.abs(tc - ffma).max())
    assert err_tc <= 3 * err_ffma, (err_tc, err_ffma)
    assert gap >= err_ffma / 4, (gap, err_ffma)
    assert gap > 100 * 2.0 ** -20, gap
