"""Model layer of the port against phyml_tpu, in float64.

Tolerance 1e-10 throughout: both sides run the same algorithms
(Newton on the regularized incomplete gamma, eigh of the symmetrized
Q) in float64, so they agree to roundoff.  P(t) is compared, never V:
eigenvector signs and order differ between the two libraries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.models import rates as jrates
from phyml_tpu.models.eigen import pmat as jpmat
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu_torch.interop import params_from_numpy
from phyml_tpu_torch.models import rates as trates
from phyml_tpu_torch.models.eigen import pmat as tpmat
from phyml_tpu_torch.models.substitution import SubstModel as TModel

TOL = 1e-10
FREQS = np.array([0.31, 0.19, 0.27, 0.23])


@pytest.mark.parametrize("median", [False, True])
@pytest.mark.parametrize("n_cat", [2, 4, 8])
def test_discrete_gamma(median, n_cat):
    for alpha in (0.05, 0.3, 1.0, 4.2, 50.0):
        jr, jw = jrates.discrete_gamma(jnp.asarray(alpha), n_cat,
                                       median=median)
        tr, tw = trates.discrete_gamma(alpha, n_cat, median=median)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=TOL)


def _pair(**kw):
    jm, tm = JModel(datatype="nt", **kw), TModel(datatype="nt", **kw)
    jp = jm.init_params(FREQS)
    if "rr_val" in jp:
        jp["rr_val"] = jnp.log(jnp.asarray([1.2, 3.0, 0.8, 1.1, 4.0, 1.0]))
    if "alpha" in jp:
        jp["alpha"] = jnp.asarray(0.43)
    if "kappa" in jp:
        jp["kappa"] = jnp.asarray(2.7)
    if "pinv" in jp:
        jp["pinv"] = jnp.asarray(0.31)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, tp


@pytest.mark.parametrize("kw", [
    dict(name="HKY85", n_classes=1),
    dict(name="GTR", n_classes=4),
    dict(name="GTR", n_classes=4, invar=True),
    dict(name="HKY85", n_classes=4, gamma_median=True),
    dict(name="TN93", n_classes=2),
    dict(name="GTR", n_classes=3, freerate=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_class_system_pmats(kw):
    jm, jp, tm, tp = _pair(**kw)
    jlam, jV, jVi, jpi, jw, jpinv = jm.class_system(jp)
    tlam, tV, tVi, tpi, tw, tpinv = tm.class_system(tp)
    C = jm.n_classes
    t = np.array([1e-6, 0.01, 0.1, 0.5, 2.0, 10.0])[:, None] \
        * np.ones((1, C))
    P_j = np.asarray(jpmat(jlam, jV, jVi, jnp.asarray(t)))
    P_t = tpmat(tlam, tV, tVi, torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(P_t, P_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(tpi.numpy(), np.asarray(jpi), atol=TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=TOL)
    assert abs(float(tpinv) - float(jpinv)) <= TOL
    np.testing.assert_allclose(np.sort(tlam.numpy(), axis=-1),
                               np.sort(np.asarray(jlam), axis=-1),
                               atol=TOL)


def test_batched_class_system_matches_single():
    """A leading batch axis on the parameters (the line search's
    parameter grid) gives each row's unbatched system."""
    _, _, tm, tp = _pair(name="GTR", n_classes=4, invar=True)
    alphas = torch.tensor([0.2, 0.9, 3.0], dtype=torch.float64)
    rr = tp["rr_val"].expand(3, -1).clone()
    rr[:, 1] = torch.tensor([0.0, 1.0, -1.0], dtype=torch.float64)
    batch = tm.class_system(dict(tp, alpha=alphas, rr_val=rr))
    for b in range(3):
        single = tm.class_system(dict(tp, alpha=alphas[b],
                                      rr_val=rr[b]))
        t = torch.full((2, 4), 0.3, dtype=torch.float64)
        np.testing.assert_allclose(
            tpmat(batch[0][b], batch[1][b], batch[2][b], t).numpy(),
            tpmat(*single[:3], t).numpy(), atol=1e-14)
        for x, y in zip(batch[3:], single[3:]):
            np.testing.assert_allclose(x[b].numpy(), y.numpy(),
                                       atol=1e-14)


def test_covarion_past_the_ladder_runs_the_big_bodies():
    """Nothing of covarion is left unported on the card: a process of
    more than 64 states (amino acids at four hidden classes, 80 states)
    runs the big bodies, at a state count padded to a multiple of 16
    (80 itself), on the streamed route."""
    from phyml_tpu_torch.ops import _build
    from phyml_tpu_torch.ops.likelihood import kernel_route

    m = TModel(datatype="aa", name="LG", covarion=True, n_hidden=4)
    assert m.ns == 80
    assert _build.rung(m.ns) == 80 and _build.is_big(_build.rung(m.ns))
    assert kernel_route(3, m.n_classes, m.ns) == ("K4", "K5")
