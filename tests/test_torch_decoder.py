"""The port's fused whole-decoder op (dvae_tpu_torch/ops/decoder.py),
forward and forward+backward, against the JAX package's Pallas kernels
(dvae_tpu/ops/decoder_pallas.py), which run in interpret mode on the CPU as
tests/test_ops.py (TestFusedDecoder) runs them.

On CPU tensors the port's wrappers run their plain versions; the CUDA
kernels are held against those plain versions on the card by chip_smoke.py.
Same inputs, made with numpy from a seed, go to both sides.  Tolerances:

  * sums, rtol 1e-5: f32 sums of the same products in another order; the
    mismatch count is an integer count of the same comparisons, exact;
  * gradients, rtol 3e-4 / atol 1e-4 (tests/test_ops.py:633): sums over up
    to 600 rows of products through five gated layers, in another order;
  * bf16 inputs: every activation and every gated cotangent is rounded to
    bf16 on both sides from f32 values that differ in their last bits, so
    one of them near a rounding boundary moves by a bf16 step (2^-8) and
    the steps compound over six layers: sums rtol 2e-2, gradients within
    5e-2 of each leaf's largest entry.

The plain #13 is also held to be the chain the kernel runs (trunk forward,
the plain version of kernel #2 on h_5, trunk backward), and the products
of the kernel's trunk passes are modelled in numpy in its split, padding
and run lengths, within 1e-6 of f64 at production depth.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvae_tpu.ops import decoder_pallas
from dvae_tpu_torch.ops import _build, decoder, recon
from test_torch_encoder import _bf16, _mma_bf16
from test_torch_recon import _pad
from test_torch_zinb import _mma_3xtf32

A, Z, L, F, D = 3, 10, 6, 16, 40
GA = np.array([0.5, -1.25, 2.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _operands(seed, B, per_arm):
    """[z, w6, b6, ..., w11, b11, x] as numpy: the reference trunk widths
    fc6 Z->L, fc7 L->F, fc8..fc10 F->F, fc11 F->D, per-arm weights."""
    r = np.random.default_rng(seed)
    mk = lambda *s: (0.3 * r.normal(size=s)).astype(np.float32)  # noqa: E731
    args = [mk(A, B, Z)]
    for k, n in ((Z, L), (L, F), (F, F), (F, F), (F, F), (F, D)):
        args += [mk(A, k, n), mk(A, n)]
    xs = (A, B, D) if per_arm else (B, D)
    args.append(np.maximum(r.normal(0.5, 1, xs), 0).astype(np.float32))
    return args


def _trunk(args):
    return [(args[1 + 2 * i], args[2 + 2 * i]) for i in range(5)]


# B=600 is ragged against the Pallas kernel's row tile
@pytest.mark.parametrize("with_mism", [True, False])
@pytest.mark.parametrize("per_arm", [False, True])
@pytest.mark.parametrize("B", [70, 600])
def test_fused_decoder_matches_pallas(B, per_arm, with_mism):
    ops = _operands(B, B, per_arm)
    jx = [jnp.asarray(o) for o in ops]
    tt = [torch.from_numpy(o) for o in ops]
    want_s, want_m = decoder_pallas.fused_decoder_mse(*jx, 0.1, with_mism)
    got_s, got_m = decoder.fused_decoder_mse(*tt, 0.1, with_mism)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # the plain version against the JAX package's own oracle
    ref_s, ref_m = decoder_pallas.decoder_mse_reference(*jx, 0.1)
    plain_s, plain_m = decoder.decoder_mse_reference(*tt, 0.1)
    np.testing.assert_allclose(plain_s.numpy(), np.asarray(ref_s), rtol=1e-5)
    np.testing.assert_array_equal(plain_m.numpy(), np.asarray(ref_m))


def _jax_grads(jx, dtype=jnp.float32):
    jx = [o.astype(dtype) for o in jx]

    def f(*a):
        sumsq, mism = decoder_pallas.fused_decoder_mse(*a, jx[13], 0.1, True)
        return jnp.sum(jnp.asarray(GA) * sumsq) + 0.0 * jnp.sum(mism)

    return jax.grad(f, tuple(range(13)))(*jx[:13])


@pytest.mark.parametrize("per_arm", [False, True])
@pytest.mark.parametrize("B", [70, 600])
def test_fused_decoder_grads_match_pallas(B, per_arm):
    """Gradients of all 13 differentiable arguments of Σ_a g_a·sumsq_a (a
    cotangent that differs per arm) against jax.grad of the Pallas op, whose
    vjp runs its fused forward+backward kernel."""
    ops = _operands(B + 1, B, per_arm)
    want = _jax_grads([jnp.asarray(o) for o in ops])
    tt = [torch.from_numpy(o) for o in ops]
    for t in tt[:13]:
        t.requires_grad_()
    sumsq, mism = decoder.fused_decoder_mse(*tt, 0.1, True)
    assert not mism.requires_grad and tt[13].grad is None
    (torch.from_numpy(GA) * sumsq).sum().backward()
    for i, (t, w_) in enumerate(zip(tt[:13], want)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w_), rtol=3e-4,
                                   atol=1e-4, err_msg=f"arg {i}")
    assert tt[13].grad is None


@pytest.mark.parametrize("per_arm", [False, True])
def test_fused_decoder_bf16_matches_pallas(per_arm):
    ops = _operands(21, 70, per_arm)
    jx = [jnp.asarray(o, jnp.bfloat16) for o in ops]
    tt = [torch.from_numpy(o).to(torch.bfloat16) for o in ops]
    want_s, want_m = decoder_pallas.fused_decoder_mse(*jx, 0.1, True)
    want = _jax_grads(jx, jnp.bfloat16)
    for t in tt[:13]:
        t.requires_grad_()
    sumsq, mism = decoder.fused_decoder_mse(*tt, 0.1, True)
    (torch.from_numpy(GA) * sumsq).sum().backward()
    assert sumsq.dtype == torch.float32
    np.testing.assert_allclose(sumsq.detach().numpy(), np.asarray(want_s),
                               rtol=2e-2)
    assert np.abs(mism.numpy() - np.asarray(want_m)).max() <= 0.01 * 70 * D
    for i, (t, w_) in enumerate(zip(tt[:13], want)):
        assert t.grad.dtype == torch.bfloat16
        w_ = np.asarray(w_, np.float32)
        err = np.abs(t.grad.float().numpy() - w_).max()
        assert err <= 5e-2 * np.abs(w_).max(), (i, err, np.abs(w_).max())


def test_fwdbwd_plain_version_matches_the_fused_jax_call():
    """``decoder_fwdbwd`` returns what ``_fwdbwd_call`` returns: sums, dz,
    the five trunk (dW, db), dW11, db11, all unscaled."""
    ops = _operands(5, 37, False)
    jx = [jnp.asarray(o) for o in ops]
    (js, jm), jdz, jdtrunk, jdw11, jdb11 = decoder_pallas._fwdbwd_call(
        jx[0], _trunk(jx), jx[11], jx[12], jx[13], 0.1, True)
    tt = [torch.from_numpy(o) for o in ops]
    s, m, dz, dtrunk, dw11, db11 = decoder.decoder_fwdbwd(
        tt[0], _trunk(tt), tt[11], tt[12], tt[13])
    got = [s, m, dz, *(t for pair in dtrunk for t in pair), dw11, db11]
    want = [js, jm, jdz, *(t for pair in jdtrunk for t in pair), jdw11, jdb11]
    assert len(got) == 15
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == tuple(w_.shape)
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)


def test_value_only_equals_the_training_sums_and_takes_the_forward_path():
    """Without a gradient the op takes the value-only path, under autograd
    the training path, with the same sums; on the CPU neither counts a
    launch."""
    tt = [torch.from_numpy(o) for o in _operands(4, 70, False)]
    counts = (decoder.fused_decoder_mse.launches,
              decoder.decoder_fwdbwd.launches)
    s0, m0 = decoder.fused_decoder_mse(*tt)
    assert s0.grad_fn is None
    tt[3].requires_grad_()
    s1, m1 = decoder.fused_decoder_mse(*tt)
    assert s1.grad_fn is not None
    with torch.no_grad():
        assert decoder.fused_decoder_mse(*tt)[0].grad_fn is None
    np.testing.assert_allclose(s1.detach().numpy(), s0.numpy(), rtol=1e-6)
    assert torch.equal(m0, m1)
    s2, m2, *_ = decoder.decoder_fwdbwd(tt[0], _trunk(tt), tt[11], tt[12],
                                        tt[13])
    assert torch.equal(s2, s1.detach()) and torch.equal(m2, m1)
    assert (decoder.fused_decoder_mse.launches,
            decoder.decoder_fwdbwd.launches) == counts


@pytest.mark.parametrize("per_arm", [False, True])
def test_autograd_function_matches_autograd_of_the_plain_version(per_arm):
    ops = _operands(8, 70, per_arm)
    grads = []
    for fn in (decoder.fused_decoder_mse, decoder.decoder_mse_reference):
        tt = [torch.from_numpy(o) for o in ops]
        for t in tt[:13]:
            t.requires_grad_()
        sumsq, _ = fn(*tt)
        (torch.from_numpy(GA) * sumsq).sum().backward()
        grads.append([t.grad for t in tt[:13]])
    for i, (g_, w_) in enumerate(zip(*grads)):
        np.testing.assert_allclose(g_.numpy(), w_.numpy(), rtol=3e-4,
                                   atol=1e-4, err_msg=f"arg {i}")


def test_dw11_and_db11_are_the_recon_kernels_given_the_same_h5():
    """The output layer's part of the training op is the fused recon op on
    the trunk's last activation."""
    tt = [torch.from_numpy(o) for o in _operands(6, 70, True)]
    s, m, _, _, dw11, db11 = decoder.decoder_fwdbwd(
        tt[0], _trunk(tt), tt[11], tt[12], tt[13])
    h5 = decoder._trunk_forward(tt[0], _trunk(tt))[-1]
    rs, rm, _, rdw, rdb = recon.recon_fwdbwd(h5, tt[11], tt[12], tt[13])
    for a, b in ((s, rs), (m, rm), (dw11, rdw), (db11, rdb)):
        assert torch.equal(a, b)


def test_nan_in_one_row_reaches_that_arms_sums_only():
    tt = [torch.from_numpy(o) for o in _operands(7, 70, False)]
    tt[0][1, 5, 2] = float("nan")
    s, _ = decoder.fused_decoder_mse(*tt)
    assert torch.isnan(s[1]) and torch.isfinite(s[[0, 2]]).all()


@pytest.mark.parametrize("bad", ["trunk_arms", "trunk_chain", "bias", "w11",
                                 "x", "rank"])
def test_wrapper_rejects_mismatched_shapes(bad):
    tt = [torch.from_numpy(o) for o in _operands(1, 8, False)]
    if bad == "trunk_arms":
        tt[1] = tt[1][:1]
    elif bad == "trunk_chain":
        tt[3] = tt[3][:, :3]
    elif bad == "bias":
        tt[4] = tt[4][:, :5]
    elif bad == "w11":
        tt[11] = tt[11][:, :7]
    elif bad == "x":
        tt[13] = tt[13][:, :5]
    else:
        tt[0] = tt[0][0]
    with pytest.raises(ValueError):
        decoder.fused_decoder_mse(*tt)


def test_wrapper_refuses_other_devices_and_the_kernel_is_registered():
    tt = [torch.from_numpy(o) for o in _operands(3, 8, False)]
    with pytest.raises(ValueError, match="unsupported device"):
        decoder.fused_decoder_mse(*[t.to("meta") for t in tt])
    assert "decoder" in _build.KERNELS
    assert (_build.CSRC / "decoder.cu").exists()
    assert (_build.CSRC / "recon_passes.cuh").exists()


# ---------------------------------------------------------------------------
# Kernel #13 as the redesign composes it, and the plan of its trunk passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_arm", [False, True])
@pytest.mark.parametrize("B", [70, 600])
def test_plain_version_is_the_kernels_decomposition(B, per_arm):
    """The chain the kernel runs, the plain trunk forward, the plain
    version of kernel #2 on h_5 and the plain trunk backward from its
    dh_5, against the JAX package's ``_fwdbwd_call`` (as
    ``test_fwdbwd_plain_version_matches_the_fused_jax_call`` holds the
    plain #13) and, scaled by a per-arm cotangent, against jax.grad of the
    Pallas op (as ``test_fused_decoder_grads_match_pallas``)."""
    ops = _operands(B + 11, B, per_arm)
    tt = [torch.from_numpy(o) for o in ops]
    z, trunk, w11, b11, x = tt[0], _trunk(tt), tt[11], tt[12], tt[13]
    hs = decoder._trunk_forward(z, trunk)
    s, m, dh5, dw11, db11 = recon.recon_fwdbwd_reference(hs[-1], w11, b11, x)
    dz, dtrunk = decoder._trunk_backward(hs, trunk, dh5)
    chain = [s, m, dz, *(t for pair in dtrunk for t in pair), dw11, db11]
    jx = [jnp.asarray(o) for o in ops]
    (js, jm), jdz, jdtrunk, jdw11, jdb11 = decoder_pallas._fwdbwd_call(
        jx[0], _trunk(jx), jx[11], jx[12], jx[13], 0.1, True)
    want = [js, jm, jdz, *(t for pair in jdtrunk for t in pair), jdw11, jdb11]
    for g_, w_ in zip(chain, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)
    grads = _jax_grads(jx)
    ga = torch.from_numpy(GA)
    for i, (g_, w_) in enumerate(zip(chain[2:], grads)):
        scaled = g_ * (ga[:, None, None] if g_.dim() == 3 else ga[:, None])
        np.testing.assert_allclose(scaled.numpy(), np.asarray(w_), rtol=3e-4,
                                   atol=1e-4, err_msg=f"arg {i}")


Z_P, L_P, F_P, B_P = 94, 10, 100, 5000  # the production trunk and batch


def _trunk_plan_operands(which, dtype, seed):
    """Operands of one of #13's trunk products at production depth: z as
    the model makes it (a soft categorical sample beside two state values),
    activations relu of a normal draw (about half exact zeros), weights at
    the smoke run's scale (1.4 / sqrt(in)), cotangents of both signs over
    five decades; bf16 operands and cotangents rounded to bf16, as the
    kernel rounds each gated cotangent for its products."""
    r = np.random.default_rng(seed)
    rows = B_P if which == "dW = h^T g (K=B)" else 64

    def w(k, n):
        return (r.standard_normal((k, n)) * 1.4 / np.sqrt(k)).astype(
            np.float32)

    def h(n):
        return np.maximum(r.standard_normal((rows, n)), 0).astype(np.float32)

    def g(n):
        return (r.standard_normal((rows, n))
                * 10.0 ** r.uniform(-3, 2, (rows, n))).astype(np.float32)

    if which == "fc6 y = z W (K=94)":
        e = np.exp(3 * r.standard_normal((rows, Z_P - 2)))
        a = np.concatenate([e / e.sum(1, keepdims=True),
                            r.standard_normal((rows, 2))], 1)
        a, b = a.astype(np.float32), w(Z_P, L_P)
    elif which == "fc7 y = h W (K=10)":
        a, b = h(L_P), w(L_P, F_P)
    elif which == "fc8 y = h W (K=100)":
        a, b = h(F_P), w(F_P, F_P)
    elif which == "g W^T (K=100)":
        a, b = g(F_P), w(F_P, F_P).T.copy()
    else:
        a, b = h(F_P).T.copy(), g(F_P)
    if dtype == "bfloat16":
        a, b = _bf16(a), _bf16(b)
    return a, b


def _trunk_plan_product(which, dtype):
    """(kernel-order result, a, b) of one trunk product of #13, summed as
    csrc/decoder.cu sums it: k padded with zeros to the mma's depth (8 in
    f32, 16 in bf16), runs of 32 values of k summed from zero (f32: 3xTF32
    in two accumulators) and added rounded to nearest.  dW sums each
    64-row tile so (two runs of 32 rows), and the tiles' partials in
    double in tile order (``decoder_grad_reduce``)."""
    a, b = _trunk_plan_operands(which, dtype, seed=sum(map(ord, which)))
    ks = 8 if dtype == "float32" else 16

    def model(u, v):
        u, v = _pad(u, 1, ks), _pad(v, 0, ks)
        if dtype == "float32":
            return _mma_3xtf32(u, v, run=32)
        return _mma_bf16(u, v, run=32)

    if which != "dW = h^T g (K=B)":
        return model(a, b), a, b
    acc = np.zeros((a.shape[0], b.shape[1]), np.float64)
    for t0 in range(0, B_P, 64):
        acc += model(a[:, t0:t0 + 64], b[t0:t0 + 64])
    return acc.astype(np.float32), a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["fc6 y = z W (K=94)", "fc7 y = h W (K=10)",
                                   "fc8 y = h W (K=100)", "g W^T (K=100)",
                                   "dW = h^T g (K=B)"])
def test_trunk_plan_keeps_f32_accuracy_at_production_depth(which, dtype):
    """Each product of #13's trunk passes at production depth (the forward
    through fc6, K = 94 -> 96; fc7, K = 10 -> 16; fc8..fc10, K = 100; the
    backward's g W^T over 100 units; dW over B = 5,000 rows in 79 tiles of
    64), in the kernel's split, padding, run lengths and order, with the
    tensor cores' sums rounded toward zero: within 1e-6 of the f64 product
    (max |Δ| / max |f64|), the margin under the chip check's 1e-5."""
    got, a, b = _trunk_plan_product(which, dtype)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - exact).max() / np.abs(exact).max() <= 1e-6


@pytest.mark.parametrize("live", [True, False])
@pytest.mark.parametrize("per_arm", [False, True])
def test_nan_of_x_gives_the_pallas_kernels_nan_pattern(per_arm, live):
    """Fault C5 through the whole decoder: a NaN of x where arm 1's r > 0
    makes gm NaN there, so dh5's row, and down the trunk every gated
    cotangent of that row, dz's row and the dW, db of every unit active on
    it, are NaN; where every reading arm's r = 0 gm is 0 and only the sums
    are NaN.  The JAX package's fused call (interpreted) and the port's
    plain version give NaN at the same places (``assert_allclose`` holds
    NaN to NaN) and agree elsewhere; this is the pattern the chip check
    holds the kernel to."""
    ops = _operands(13, 24, per_arm)
    h = ops[0].astype(np.float64)
    for w_, b_ in _trunk(ops):
        h = np.maximum(np.einsum("abk,akn->abn", h, w_) + b_[:, None, :], 0)
    y = np.einsum("abf,afd->abd", h, ops[11]) + ops[12][:, None, :]
    ok = (y[1] > 0.05) if live else (
        y[1] < -0.05 if per_arm else (y < -0.05).all(axis=0))
    i, j = map(int, np.argwhere(ok)[0])
    ops[13] = ops[13].copy()
    ops[13][(1, i, j) if per_arm else (i, j)] = np.nan
    jx = [jnp.asarray(o) for o in ops]
    (js, jm), jdz, jdtrunk, jdw11, jdb11 = decoder_pallas._fwdbwd_call(
        jx[0], _trunk(jx), jx[11], jx[12], jx[13], 0.1, True)
    tt = [torch.from_numpy(o) for o in ops]
    s, m, dz, dtrunk, dw11, db11 = decoder.decoder_fwdbwd(
        tt[0], _trunk(tt), tt[11], tt[12], tt[13])
    got = [s, m, dz, *(t for pair in dtrunk for t in pair), dw11, db11]
    want = [js, jm, jdz, *(t for pair in jdtrunk for t in pair), jdw11, jdb11]
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)
    assert np.isnan(s.numpy()[1])
    grads = [t.numpy() for t in got[2:]]
    if live:
        assert np.isnan(dz.numpy()[1, i]).all()
        assert np.isnan(dz.numpy()).any(axis=2).sum() <= 3
        assert np.isnan(db11.numpy()[1, j])
    else:
        assert all(np.isfinite(t).all() for t in grads)
