"""The port's fused dropout + fc1 (dvae_tpu_torch/ops/encoder.py) against the
JAX package's Pallas kernel (dvae_tpu/ops/encoder_pallas.py), which runs in
interpret mode on the CPU as the JAX tests run it.

On CPU tensors the port's wrappers run their plain versions; the CUDA
kernels themselves are held against those plain versions on the card by
chip_smoke.py.  Both sides get the same inputs (numpy, from a seed) and the
same explicit keep-mask (the JAX package's own host mask).  Tolerances:

  * f32 (rtol 1e-5, atol 1e-5): the same products summed in another
    order, as tests/test_ops.py holds the JAX kernel; gradients (rtol 2e-4,
    atol 2e-4) sum up to 600 rows of terms as large as 10², whose f32
    rounding reaches 1e-4 in absolute terms on entries near zero;
  * bf16 outputs (rtol 8e-3, atol 8e-3): one bf16 rounding step (2^-8) of
    an f32 sum that differs in its last bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvae_tpu.ops import encoder_pallas
from dvae_tpu_torch.ops import _build, encoder
# the tensor core's tf32 rounding, modelled once for both kernels' tests
from test_torch_zinb import _mma_3xtf32, _rz, _tf32

F32 = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=8e-3, atol=8e-3)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(A=3, B=70, D=48, F=16, seed=9):
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, D)).astype(np.float32)
    w = (0.1 * r.normal(size=(A, D, F))).astype(np.float32)
    b = (0.1 * r.normal(size=(A, F))).astype(np.float32)
    return x, w, b


def _jax_mask(A, B, D, rate, seed=3):
    return np.array(encoder_pallas.dropout_mask_host(seed, (A, B, D), rate))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_arm", [False, True])
@pytest.mark.parametrize("B", [70, 600])
def test_fused_dropout_fc1_matches_pallas(B, per_arm, dtype):
    x, w, b = _data(B=B, D=48 if B == 600 else 120, F=16 if B == 600 else 24)
    A, D, F = w.shape
    if per_arm:
        x = np.stack([x * (1 + 0.1 * a) for a in range(A)])
    mask = _jax_mask(A, B, D, 0.5)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw, jb = (jnp.asarray(v, jd) for v in (x, w, b))
    tx, tw, tb = (torch.from_numpy(v).to(td) for v in (x, w, b))
    tm = torch.from_numpy(mask)

    y_j = encoder_pallas.fused_dropout_fc1(jnp.int32(3), jx, jw, jb, 0.5,
                                           jnp.asarray(mask))
    tw.requires_grad_()
    tb.requires_grad_()
    y_t = encoder.fused_dropout_fc1(3, tx, tw, tb, 0.5, tm)
    assert y_t.dtype == td and tuple(y_t.shape) == (A, B, F)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(y_t.detach().float().numpy(),
                               np.asarray(y_j, np.float32), **tol)

    def f(w_, b_):
        y = encoder_pallas.fused_dropout_fc1(jnp.int32(3), jx, w_, b_, 0.5,
                                             jnp.asarray(mask))
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))

    gw_j, gb_j = jax.grad(f, (0, 1))(jw, jb)
    torch.sin(y_t.float()).sum().backward()
    assert tw.grad.dtype == td and tb.grad.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw_j),
                                   **F32_GRAD)
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb_j),
                                   **F32_GRAD)
    else:
        # the cotangent cos(y) is taken of two bf16 outputs that may differ
        # by one rounding step: compare the gradients at the sum's scale
        for got, want in ((tw.grad, gw_j), (tb.grad, gb_j)):
            want = np.asarray(want, np.float32)
            err = np.abs(got.float().numpy() - want).max()
            assert err <= 2e-2 * (np.abs(want).max() + 1), err


@pytest.mark.parametrize("per_arm", [False, True])
def test_plain_versions_match_the_jax_oracle(per_arm):
    x, w, b = _data(B=33, D=40, F=8, seed=2)
    A, D, F = w.shape
    if per_arm:
        x = np.stack([x + a for a in range(A)])
    mask = _jax_mask(A, 33, D, 0.3, seed=5)
    want = encoder_pallas.dropout_fc1_reference(jnp.asarray(x), jnp.asarray(w),
                                                jnp.asarray(b), 0.3,
                                                jnp.asarray(mask))
    got = encoder.dropout_fc1_reference(torch.from_numpy(x),
                                        torch.from_numpy(w),
                                        torch.from_numpy(b), 0.3,
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    g = np.random.default_rng(4).normal(size=(A, 33, F)).astype(np.float32)
    dw, db = encoder.dropout_fc1_grad_reference(
        torch.from_numpy(x), torch.from_numpy(g), 0.3,
        torch.from_numpy(mask))
    xs = x if per_arm else np.broadcast_to(x, (A, 33, D))
    xd = np.where(mask, xs / np.float32(0.7), 0).astype(np.float32)
    np.testing.assert_allclose(dw.numpy(), np.einsum("abd,abf->adf", xd, g),
                               **F32)
    np.testing.assert_allclose(db.numpy(), g.sum(1), **F32)


def test_rate_zero_is_identity_and_an_explicit_mask_wins():
    x, w, b = (torch.from_numpy(v) for v in _data(B=20, D=40, F=8))
    A, D, _ = w.shape
    y0 = encoder.encoder_fwd(1, x, w, b, 0.0)
    plain = torch.einsum("bd,adf->abf", x, w) + b[:, None]
    np.testing.assert_allclose(y0.numpy(), plain.numpy(), **F32)
    zeros = torch.zeros((A, 20, D), dtype=torch.bool)
    y_mask = encoder.encoder_fwd(1, x, w, b, 0.0, zeros)
    np.testing.assert_allclose(y_mask.numpy(),
                               b[:, None].expand(A, 20, -1).numpy(), **F32)


def test_philox_mask_keep_fraction_and_cpu_path():
    """The numpy Philox (the in-kernel draw's plain version) keeps 1 − rate
    of the elements within 5σ, differs across arms and seeds, and is what
    the CPU wrappers draw when no mask is given."""
    A, B, D, rate = 3, 64, 52, 0.5
    m = encoder.philox_keep_mask(11, (A, B, D), rate)
    n = m.size
    assert abs(m.mean() - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n)
    assert (m[0] != m[1]).any()
    assert (m != encoder.philox_keep_mask(12, (A, B, D), rate)).any()
    assert encoder.keep_threshold(0.0) == (1 << 31) - 1
    x, w, b = (torch.from_numpy(v) for v in _data(B=B, D=D, F=8))
    got = encoder.encoder_fwd(11, x, w, b, rate)
    want = encoder.dropout_fc1_reference(x, w, b, rate, torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    g = torch.ones((A, B, 8))
    dw, _ = encoder.encoder_bwd(11, x, g, rate)
    dw_m, _ = encoder.encoder_bwd(11, x, g, rate, torch.from_numpy(m))
    assert torch.equal(dw, dw_m)


def test_host_mask_draws_from_the_generator():
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    a = encoder.dropout_mask_host(g1, (2, 50, 40), 0.25)
    assert a.dtype == torch.bool
    assert torch.equal(a, encoder.dropout_mask_host(g2, (2, 50, 40), 0.25))
    assert abs(a.float().mean().item() - 0.75) < 0.05


def test_cpu_tensors_take_the_plain_version_without_counting():
    x, w, b = (torch.from_numpy(v) for v in _data(B=10, D=40, F=8))
    mask = torch.ones((3, 10, 40), dtype=torch.bool)
    before = (encoder.encoder_fwd.launches, encoder.encoder_bwd.launches)
    w.requires_grad_()
    encoder.fused_dropout_fc1(0, x, w, b, 0.5, mask).sum().backward()
    assert (encoder.encoder_fwd.launches,
            encoder.encoder_bwd.launches) == before


@pytest.mark.parametrize("bad", ["x_width", "x_arms", "bias", "mask", "rate"])
def test_wrappers_reject_bad_operands(bad):
    x, w, b = (torch.from_numpy(v) for v in _data(B=10, D=40, F=8))
    mask, rate = None, 0.5
    if bad == "x_width":
        x = x[:, :5]
    elif bad == "x_arms":
        x = x.expand(2, 10, 40)
    elif bad == "bias":
        b = b[:, :3]
    elif bad == "mask":
        mask = torch.ones((3, 10, 7), dtype=torch.bool)
    else:
        rate = 1.0
    with pytest.raises(ValueError):
        encoder.encoder_fwd(0, x, w, b, rate, mask)


def test_wrappers_refuse_other_devices():
    x, w, b = (torch.from_numpy(v).to("meta")
               for v in _data(B=10, D=40, F=8))
    with pytest.raises(ValueError, match="unsupported device"):
        encoder.encoder_fwd(0, x, w, b, 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        encoder.encoder_bwd(0, x, torch.ones((3, 10, 8), device="meta"), 0.5)


def test_build_lists_the_training_kernels():
    assert {"recon_fwd", "recon_fwdbwd", "encoder_fc1"} <= set(_build.KERNELS)
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()


# ---------------------------------------------------------------------------
# The 3xTF32 split of the forward kernel's f32 product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_split_tf32_product_keeps_f32_accuracy_at_depth_5032(rate):
    """One 64-row tile of kernel #4's forward at the production depth
    (D = 5032, F = 100 padded to 104), summed as the kernel sums it (one
    stage of 32 at a time): within 1e-6 of the f64 product (max |Δ| / max
    |f64|), the margin under which the f32 tolerance of PERF.md §2 (y1 ≤
    1e-5) stands.  Carrying one accumulator through all 1,887 mma, whose
    sums the tensor core rounds toward zero, drifts past 1e-5 (3.3e-5 on
    the H100, PERF.md §6); plain TF32 misses by orders of magnitude."""
    r = np.random.default_rng(17)
    x = np.maximum(r.standard_normal((64, 5032)), 0).astype(np.float32)
    if rate:
        keep = r.random(x.shape) >= rate
        x = np.where(keep, x * np.float32(1.0 / (1.0 - rate)),
                     np.float32(0))
    w = np.zeros((5032, 104), np.float32)
    w[:, :100] = 0.02 * r.standard_normal((5032, 100))
    exact = x.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(exact).max()
    got = _mma_3xtf32(x, w, run=32)
    assert np.abs(got - exact).max() / scale <= 1e-6
    assert not got[:, 100:].any()  # padding columns stay 0
    carried = _mma_3xtf32(x, w, carry=True)
    assert np.abs(carried - exact).max() / scale > 1e-5
    plain = _tf32(x).astype(np.float64) @ _tf32(w).astype(np.float64)
    assert np.abs(plain - exact).max() / scale > 1e-4


# ---------------------------------------------------------------------------
# The backward kernel's plan: xᵀ g over the rows, runs of one stage
# ---------------------------------------------------------------------------

def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _mma_bf16(a, b, run=64, carry=False):
    """a @ b as the bf16 tensor-core products form it: per mma 16 values
    of k whose products are exact, summed with the accumulator and rounded
    toward zero; per run of ``run`` values of k from zero, the run then
    added to the f32 accumulator rounded to nearest (``carry``: one
    accumulator carried through every mma)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for r0 in range(0, a.shape[1], run):
        t = acc if carry else np.zeros_like(acc)
        for k0 in range(r0, min(r0 + run, a.shape[1]), 16):
            k = slice(k0, k0 + 16)
            t = _rz(t + a[:, k].astype(np.float64) @ b[k].astype(np.float64))
        acc = t if carry else (acc + t).astype(np.float32)
    return acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plan_keeps_f32_accuracy_at_depth_5000(dtype):
    """One block of kernel #5 at the production depth: dW1 = xᵀ g for 64
    genes and F = 100 padded to 104, over B = 5000 rows of dropped x (rate
    0.5) and a cotangent of both signs, summed as the kernel sums it (one
    stage at a time from zero: 32 rows of 3xTF32 products for f32, 64
    rows of bf16 products; the stage's sum added rounded to nearest).
    Within 1e-6 of the f64 product (max |Δ| / max |f64|), the margin under
    the chip check's 1e-5 for both types.  One accumulator carried through
    every mma misses that margin: in f32 (1,875 mma) by more than the
    tolerance itself, in bf16 (313 mma) by a factor of three."""
    r = np.random.default_rng(23)
    x = np.maximum(r.standard_normal((5000, 64)), 0).astype(np.float32)
    x = np.where(r.random(x.shape) >= 0.5, x * np.float32(2.0),
                 np.float32(0))
    g = np.zeros((5000, 104), np.float32)
    g[:, :100] = r.standard_normal((5000, 100))
    if dtype == "bfloat16":
        x, g = _bf16(x), _bf16(g)
    xt = x.T.copy()
    exact = xt.astype(np.float64) @ g.astype(np.float64)
    scale = np.abs(exact).max()
    if dtype == "float32":
        got, carried = (_mma_3xtf32(xt, g, run=32),
                        _mma_3xtf32(xt, g, carry=True))
    else:
        got, carried = _mma_bf16(xt, g), _mma_bf16(xt, g, carry=True)
    assert np.abs(got - exact).max() / scale <= 1e-6
    assert not got[:, 100:].any()  # padding columns stay 0
    miss = np.abs(carried - exact).max() / scale
    assert miss > (1e-5 if dtype == "float32" else 3e-6)
