"""The PyTorch port's ZINB ops (dvae_tpu_torch/ops/zinb.py, and the separate
recon backward of ops/recon.py) against dvae_tpu/ops/zinb_pallas.py and
dvae_tpu/ops/recon_pallas.py.

Inputs come from numpy seeds.  JAX runs on the CPU with its Pallas kernels
in interpret mode, as tests/test_ops.py::TestFusedZINB runs them; the port
on CPU tensors runs its plain versions, which compute what the CUDA
kernels compute.  Small shapes (A=2-3, B=70 and 600, F=16, D=40).
Tolerances, with their reason:

  * lgamma, digamma and their difference (rtol 3e-6-class): the same
    formula in both packages, a few f32 roundings apart (XLA fuses
    multiply-adds and folds constant divisions, torch does not);
  * ``VALUE`` (rtol 1e-5) and ``GRADS`` (rtol 1e-3, atol 1e-4 of each
    gradient's largest entry): f32 sums in another order; the interpreted
    TPU kernel divides by a reciprocal with a Newton step where the port
    divides (dvae_tpu/ops/zinb_pallas.py:118-140).  rtol 1e-4 holds for
    all but 4 of 19,200 dh entries at B=600 (3.4e-4): those sum over
    elements with a tiny positive rate, where ψ(r) ≈ −1/r is of order
    1e5 and one rounding of the division shows; 1e-3 leaves a factor of
    three for another summation order;
  * against the materialising oracle with the library lgamma: the JAX
    test's own rtol 2e-4 (values) and rtol 5e-3, atol 3e-3 (gradients),
    tests/test_ops.py:441-463;
  * bf16: inputs rounded to bf16 on both sides, rtol 2e-3 on values and
    2e-2 of the largest entry on gradients (gm is rounded to bf16 from
    f32 values that differ in their last bits).
"""

import numpy as np
import pytest
import torch
from scipy.special import digamma as sp_digamma, gammaln

import jax
import jax.numpy as jnp

from dvae_tpu.ops import recon_pallas, zinb_pallas

from dvae_tpu_torch.ops import recon as trecon
from dvae_tpu_torch.ops import zinb as tzinb

VALUE = 1e-5
GRADS = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(A=2, B=70, F=16, D=40, seed=11, per_arm=False):
    """The inputs of tests/test_ops.py::TestFusedZINB._data, as numpy."""
    r = np.random.default_rng(seed)
    h = r.normal(size=(A, B, F)).astype(np.float32)
    heads = []
    for _ in range(3):
        heads += [0.1 * r.normal(size=(A, F, D)).astype(np.float32),
                  0.1 * r.normal(size=(A, D)).astype(np.float32)]
    shape = (A, B, D) if per_arm else (B, D)
    x = (np.maximum(r.normal(0.8, 1, shape), 0)
         * (r.random(shape) > 0.5)).astype(np.float32)
    return [h, *heads, x]


def _t(arrays, dtype=torch.float32, grad=False):
    out = [torch.from_numpy(np.array(a)).to(dtype) for a in arrays]
    if grad:
        for t in out[:7]:
            t.requires_grad_()
    return out


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _scaled_close(got, want, rtol, atol, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# lgamma / digamma / the difference form
# ---------------------------------------------------------------------------

def test_lgamma_digamma_match_jax_and_scipy():
    xs = (10 ** np.linspace(-6, 6, 3000)).astype(np.float32)
    lg = tzinb.lgamma(torch.from_numpy(xs)).numpy()
    dg = tzinb.digamma(torch.from_numpy(xs)).numpy()
    # the same formula: a few roundings of the (u − ½)·log u term apart
    np.testing.assert_allclose(lg, np.asarray(zinb_pallas.lgamma(
        jnp.asarray(xs))), rtol=3e-6, atol=3e-6)
    np.testing.assert_allclose(dg, np.asarray(zinb_pallas.digamma(
        jnp.asarray(xs))), rtol=3e-6, atol=3e-6)
    # against scipy, tests/test_ops.py:388-396
    x64 = xs.astype(np.float64)
    np.testing.assert_allclose(lg, gammaln(x64), rtol=3e-5, atol=2e-4)
    np.testing.assert_allclose(dg, sp_digamma(x64), rtol=2e-4, atol=3e-4)


@pytest.mark.parametrize("k", [0.0, 1.0, 7.0, 1e3, 1e6])
def test_lgdg_diff_matches_jax_and_scipy(k):
    r = np.asarray(10 ** np.linspace(-6, 6, 200), np.float32)
    r64 = r.astype(np.float64)
    dlg, ddg = tzinb._lgdg_diff(torch.tensor(k, dtype=torch.float32),
                                torch.from_numpy(r))
    jlg, jdg = zinb_pallas._lgdg_diff(jnp.float32(k), jnp.asarray(r),
                                      zinb_pallas._div)
    # the difference cancels intermediates of size lnΓ(r+k): rounding of
    # that magnitude on top of the usual tolerance (test_ops.py:411-417)
    big = np.abs(gammaln(r64 + k))
    assert (np.abs(dlg.numpy() - np.asarray(jlg))
            <= 3e-6 + 3e-6 * np.abs(np.asarray(jlg)) + 4e-7 * big).all()
    np.testing.assert_allclose(ddg.numpy(), np.asarray(jdg), rtol=1e-5,
                               atol=1e-5)
    want_lg = gammaln(r64) - gammaln(r64 + k)
    err = np.abs(dlg.numpy().astype(np.float64) - want_lg)
    assert (err <= 3e-4 + 3e-5 * np.abs(want_lg) + 4e-7 * big).all()
    np.testing.assert_allclose(ddg.numpy(), sp_digamma(r64)
                               - sp_digamma(r64 + k), rtol=2e-4, atol=4e-4)
    only_lg, none = tzinb._lgdg_diff(torch.tensor(k), torch.from_numpy(r),
                                     want_dg=False)
    assert none is None and torch.equal(only_lg, dlg)


@pytest.mark.parametrize("k,r", [(1e12, 1e-6), (1e12, 1e6), (0.0, 5e9),
                                 (1e12, 5e9)])
def test_lgdg_diff_is_finite_at_the_clamp_extremes(k, r):
    dlg, ddg = tzinb._lgdg_diff(torch.tensor(k, dtype=torch.float32),
                                torch.tensor(r, dtype=torch.float32))
    assert np.isfinite(float(dlg)) and np.isfinite(float(ddg))
    jlg, jdg = zinb_pallas._lgdg_diff(jnp.float32(k), jnp.float32(r),
                                      zinb_pallas._div)
    np.testing.assert_allclose(float(dlg), float(jlg), rtol=1e-6)
    np.testing.assert_allclose(float(ddg), float(jdg), rtol=1e-5, atol=1e-6)


def test_lgamma_past_the_p4_overflow():
    """tests/test_ops.py:695-709 on the port's functions."""
    xs = np.array([1e9, 4e9, 6e9, 1e10, 1e12], np.float32)
    got = tzinb.lgamma(torch.from_numpy(xs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, gammaln(xs.astype(np.float64)), rtol=1e-6)
    dg = tzinb.digamma(torch.from_numpy(xs)).numpy()
    assert np.isfinite(dg).all()
    np.testing.assert_allclose(dg, sp_digamma(xs.astype(np.float64)),
                               rtol=1e-3)


def test_counts_clamp_and_dtype():
    x = torch.tensor([0.0, 1.0, 13.8, 40.0], dtype=torch.bfloat16)
    k = tzinb._counts(x)
    assert k.dtype == torch.float32 and float(k[-1]) == float(np.float32(1e12))
    np.testing.assert_allclose(k.numpy(), np.asarray(zinb_pallas._counts(
        jnp.asarray(x.float().numpy(), jnp.bfloat16))), rtol=1e-6)


# ---------------------------------------------------------------------------
# fused_zinb: value and gradients
# ---------------------------------------------------------------------------

def _weighted_grads_torch(args, dtype=torch.float32):
    t = _t(args, dtype, grad=True)
    s = tzinb.fused_zinb(*t)
    A = s.shape[0]
    wgt = torch.arange(1, A + 1, dtype=torch.float32)
    grads = torch.autograd.grad((s * wgt).sum(), t[:7])
    return s.detach(), grads


def _weighted_grads_jax(fn, args, dtype=jnp.float32):
    j = _j(args, dtype)
    A = j[0].shape[0]
    wgt = jnp.arange(1, A + 1, dtype=jnp.float32)
    s = fn(*j)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a, j[7]) * wgt),
                     tuple(range(7)))(*j[:7])
    return s, grads


@pytest.mark.parametrize("per_arm", [False, True])
@pytest.mark.parametrize("B", [70, 600])
def test_fused_zinb_matches_jax_kernel(B, per_arm):
    """Value and all seven gradients, a non-uniform per-arm cotangent,
    against the TPU kernels in interpret mode."""
    args = _data(B=B, per_arm=per_arm)
    s, grads = _weighted_grads_torch(args)
    js, jgrads = _weighted_grads_jax(zinb_pallas.fused_zinb, args)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=VALUE)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert g.dtype == torch.float32
        _scaled_close(g.numpy(), jg, **GRADS, msg=tzinb._OPERANDS[i])


@pytest.mark.parametrize("B", [70, 600])
def test_fused_zinb_matches_the_lgamma_oracle(B):
    args = _data(B=B)
    s, grads = _weighted_grads_torch(args)
    t = _t(args, grad=True)
    s0 = tzinb.zinb_heads_reference(*t)
    wgt = torch.arange(1, s0.shape[0] + 1, dtype=torch.float32)
    g0 = torch.autograd.grad((s0 * wgt).sum(), t[:7])
    np.testing.assert_allclose(s.numpy(), s0.detach().numpy(), rtol=2e-4)
    for g, e in zip(grads, g0):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=5e-3, atol=3e-3)
    # and the oracle is the JAX package's
    js0 = zinb_pallas.zinb_heads_reference(*_j(args))
    np.testing.assert_allclose(s0.detach().numpy(), np.asarray(js0),
                               rtol=VALUE)


def test_value_only_call_and_autograd_of_the_plain_version():
    """A no-grad call returns the training call's value; autograd through
    ``zinb_heads_plain`` equals the analytic gradients."""
    args = _data()
    s, grads = _weighted_grads_torch(args)
    with torch.no_grad():
        v = tzinb.fused_zinb(*_t(args))
    np.testing.assert_allclose(v.numpy(), s.numpy(), rtol=1e-6)
    t = _t(args, grad=True)
    p = tzinb.zinb_heads_plain(*t)
    wgt = torch.arange(1, p.shape[0] + 1, dtype=torch.float32)
    auto = torch.autograd.grad((p * wgt).sum(), t[:7])
    for g, e in zip(grads, auto):
        _scaled_close(g.numpy(), e.numpy(), **GRADS)
    assert t[7].grad is None


def test_fused_zinb_bf16_matches_jax_kernel():
    args = _data(B=70)
    rounded = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in args]
    s, grads = _weighted_grads_torch(rounded, torch.bfloat16)
    js, jgrads = _weighted_grads_jax(zinb_pallas.fused_zinb, rounded,
                                     jnp.bfloat16)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-3)
    for g, jg in zip(grads, jgrads):
        assert g.dtype == torch.bfloat16      # cotangents in primal dtypes
        _scaled_close(g.float().numpy(), np.asarray(jg.astype(jnp.float32)),
                      rtol=2e-2, atol=2e-2)


def test_huge_counts_loss_and_gradients_finite():
    """tests/test_ops.py:711 on the port: counts ≈ 9.7e9 pass the P4
    overflow; loss equals the oracle, gradients stay finite."""
    r = np.random.default_rng(5)
    A, B, F, D = 2, 16, 8, 24
    h = r.normal(size=(A, B, F)).astype(np.float32)
    w = lambda: 0.1 * r.normal(size=(A, F, D)).astype(np.float32)  # noqa: E731
    b = np.zeros((A, D), np.float32)
    x = np.full((B, D), 23.0, np.float32)
    args = [h, w(), b, w(), b, w(), b, x]
    s, grads = _weighted_grads_torch(args)
    assert np.isfinite(s.numpy()).all()
    np.testing.assert_allclose(
        s.numpy(), tzinb.zinb_heads_reference(*_t(args)).numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        s.numpy(), np.asarray(zinb_pallas.fused_zinb(*_j(args))), rtol=1e-5)
    for g in grads:
        assert np.isfinite(g.numpy()).all()


def test_nan_in_h_gives_nan_loss_and_nan_in_x_does_not():
    """As the JAX op: a NaN activation poisons its arm's sum; a NaN target
    fails ``k > 0`` and lands in the zero branch."""
    args = _data()
    args[0][1, 3, 2] = np.nan
    got = tzinb.fused_zinb(*_t(args)).numpy()
    want = np.asarray(zinb_pallas.fused_zinb(*_j(args)))
    assert np.isnan(got[1]) and np.isnan(want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=VALUE)
    args = _data()
    args[7][5, 5] = np.nan
    got = tzinb.fused_zinb(*_t(args)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(zinb_pallas.fused_zinb(*_j(args))), rtol=VALUE)


# ---------------------------------------------------------------------------
# The separate backward kernels' plain versions
# ---------------------------------------------------------------------------

def _flat(grads):
    dh, gr, gp, gz = grads
    return [dh, *gr, *gp, *gz]


def test_zinb_bwd_ones_equals_the_stashed_gradients():
    """tests/test_ops.py:556-580: the separate backward at cotangent 1
    equals the fused call's unscaled gradients."""
    args = _t(_data(B=50, F=6, D=16, seed=12))
    loss, *fused = tzinb.zinb_fwdbwd(*args)
    heads = tuple(zip(args[1:7:2], args[2:7:2]))
    sep = tzinb.zinb_bwd(torch.ones(args[0].shape[0]), args[0], heads,
                         args[7])
    np.testing.assert_allclose(loss.numpy(),
                               tzinb.fused_zinb(*args).numpy(), rtol=1e-6)
    for g, e in zip(_flat(sep), _flat(fused)):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("per_arm", [False, True])
def test_zinb_bwd_matches_jax_bwd_kernel(per_arm):
    data = _data(A=3, B=70, per_arm=per_arm)
    g = np.array([0.5, -2.0, 3.0], np.float32)
    t = _t(data)
    heads = tuple(zip(t[1:7:2], t[2:7:2]))
    got = _flat(tzinb.zinb_bwd(torch.from_numpy(g), t[0], heads, t[7]))
    j = _j(data)
    jheads = tuple(zip(j[1:7:2], j[2:7:2]))
    want = _flat(zinb_pallas._bwd_call(jnp.asarray(g), j[0], jheads,
                                       zinb_pallas._counts(j[7]), 1e-6))
    for a, e in zip(got, want):
        _scaled_close(a.numpy(), e, **GRADS)


@pytest.mark.parametrize("per_arm", [False, True])
def test_recon_bwd_matches_jax_bwd_kernel(per_arm):
    rng = np.random.default_rng(11)
    A, B, F, D = 2, 70, 8, 24          # a partial edge tile in JAX
    h = rng.normal(0, 1, (A, B, F)).astype(np.float32)
    w = rng.normal(0, 0.3, (A, F, D)).astype(np.float32)
    b = rng.normal(0, 0.1, (A, D)).astype(np.float32)
    x = rng.random((A, B, D) if per_arm else (B, D)).astype(np.float32)
    g = np.array([1.5, -0.5], np.float32)
    got = trecon.recon_bwd(*_t([g, h, w, b, x]))
    want = recon_pallas._bwd_call(*_j([g, h, w, b, x]))
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-5,
                                   atol=1e-5)
    # at cotangent 1 it equals the fused call's unscaled gradients
    ones = trecon.recon_bwd(torch.ones(A), *_t([h, w, b, x]))
    fused = trecon.recon_fwdbwd(*_t([h, w, b, x]))[2:]
    for a, e in zip(ones, fused):
        assert torch.equal(a, e)


def test_wrappers_check_their_operands():
    t = _t(_data())
    with pytest.raises(ValueError, match="head p"):
        tzinb.fused_zinb(t[0], t[1], t[2], t[3][:, :, :-1], t[4], t[5], t[6],
                         t[7])
    with pytest.raises(ValueError, match="neither"):
        tzinb.fused_zinb(*t[:7], t[7][:-1])
    heads = tuple(zip(t[1:7:2], t[2:7:2]))
    with pytest.raises(ValueError, match="g "):
        tzinb.zinb_bwd(torch.ones(5), t[0], heads, t[7])
    with pytest.raises(ValueError, match="g "):
        trecon.recon_bwd(torch.ones(5), t[0], t[1], t[2], t[7])
    assert tzinb.fused_zinb.launches == 0 and tzinb.zinb_fwdbwd.launches == 0
    assert tzinb.zinb_bwd.launches == 0 and trecon.recon_bwd.launches == 0


# ---------------------------------------------------------------------------
# The 3xTF32 split of the training kernel's f32 products
# ---------------------------------------------------------------------------

def _tf32(a):
    """``a`` rounded to tf32 (10 explicit mantissa bits), to nearest even,
    through the int32 view."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = u.astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def _rz(v):
    """f64 values to f32, rounded toward zero (the tensor core's sums)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma_3xtf32(a, b, run=8, carry=False, one_acc=False):
    """a @ b as csrc/mma.cuh forms it: a = a_hi + a_lo, b = b_hi + b_lo,
    all four tf32.  Per run of ``run`` values of k the products hi·hi and
    the cross terms lo·hi + hi·lo are summed from zero in two accumulators,
    one mma (8 deep, products exact) at a time, each sum rounded toward
    zero as the tensor core rounds it; the run's two sums then join the
    f32 accumulator rounded to nearest (``one_acc``: all three products of
    the run in one accumulator, as the y products run).  ``carry``: one
    accumulator carried through every mma instead, the form the kernels
    avoid."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    f64 = lambda u, v, k: u[:, k].astype(np.float64) @ v[k]  # noqa: E731
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for r0 in range(0, a.shape[1], run):
        big, small = np.zeros_like(acc), np.zeros_like(acc)
        for k0 in range(r0, min(r0 + run, a.shape[1]), 8):
            k = slice(k0, k0 + 8)
            if carry:
                for u, v in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                    acc = _rz(acc + f64(u, v, k))
                continue
            if one_acc:
                for u, v in ((a_lo, b_hi), (a_hi, b_hi), (a_hi, b_lo)):
                    big = _rz(big + f64(u, v, k))
                continue
            small = _rz(small + f64(a_lo, b_hi, k))
            big = _rz(big + f64(a_hi, b_hi, k))
            small = _rz(small + f64(a_hi, b_lo, k))
        if not carry:
            acc = (acc + (big + small)).astype(np.float32)
    return acc


def _tile_operands(which, seed=5):
    """Production-like operands of one tile product of kernel #7: h ∈
    [0, 1) with exact zeros, head weights in ±0.1 (the smoke run's), and
    cotangents over five decades of both signs (ψ(r) ≈ −1/r makes tiny
    rates large)."""
    r = np.random.default_rng(seed)
    h = r.random((64, 100), dtype=np.float32)
    h[::7] = 0.0
    w = ((r.random((100, 64), dtype=np.float32) - 0.5) * 0.2)
    g = (r.standard_normal((64, 64))
         * 10.0 ** r.uniform(-3, 2, (64, 64))).astype(np.float32)
    return {"y = h W (K=100)": (h, w),
            "dh = g W^T (K=64)": (g, w.T.copy()),
            "dW = h^T g (K=64)": (h.T.copy(), g)}[which]


@pytest.mark.parametrize("which,run,one_acc", [
    ("y = h W (K=100)", 32, True), ("dh = g W^T (K=64)", 8, False),
    ("dW = h^T g (K=64)", 32, False)])
def test_split_tf32_products_keep_f32_accuracy(which, run, one_acc):
    """The 3xTF32 products of zinb_fwdbwd.cu, summed as the kernel sums
    them (y four k steps of 8 at a time in one accumulator, dh one step's
    8 columns, dW one step's 32 rows), stay within 1e-6 of the f64 product
    (max |Δ| / max
    |f64|), the margin under which the f32 tolerances of PERF.md §2
    (gradients 1e-4, loss 1e-5) stand; plain TF32 misses by orders of
    magnitude, which is why it is not used."""
    a, b = _tile_operands(which)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    err = np.abs(_mma_3xtf32(a, b, run, one_acc=one_acc) - exact).max() / scale
    assert err <= 1e-6, err
    plain = _tf32(a).astype(np.float64) @ _tf32(b).astype(np.float64)
    assert np.abs(plain - exact).max() / scale > 1e-4
