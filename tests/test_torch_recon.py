"""The port's fused recon loss (dvae_tpu_torch/ops/recon.py), forward and
forward+backward, against the JAX package's Pallas kernels
(dvae_tpu/ops/recon_pallas.py), which run in interpret mode on the CPU as
the JAX tests run them.

On CPU tensors the port's wrapper runs its plain version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py.
Same inputs, made with numpy from a seed, go to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvae_tpu.ops import recon_pallas
from dvae_tpu_torch.ops import _build, _common, recon

# f32 sums of the same products in another order: relative 1e-5.  The
# mismatch count is an integer count of the same comparisons: exact.
# Gradients (rtol 1e-4, atol 1e-4 · max|grad|): sums over up to 520 rows or
# 40 columns of products, in another order; under bf16 gm is rounded to
# bf16 for the products on both sides, so a gm near a rounding boundary
# moves a product by one bf16 step (2^-8): rtol 2e-2 of max|grad|.
RTOL_SUMSQ = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _operands(seed, A, B, F, D, per_arm):
    rng = np.random.default_rng(seed)
    h = rng.random((A, B, F), dtype=np.float32)
    w = ((rng.random((A, F, D)) - 0.5) * 0.5).astype(np.float32)
    b = ((rng.random((A, D)) - 0.5) * 0.2).astype(np.float32)
    xs = (A, B, D) if per_arm else (B, D)
    x = np.maximum(rng.normal(size=xs), 0.0).astype(np.float32)
    return h, w, b, x


# B=520 is ragged against the Pallas kernel's 512-row tile
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mism", [True, False])
@pytest.mark.parametrize("per_arm", [False, True])
@pytest.mark.parametrize("B", [16, 520])
def test_fused_recon_matches_pallas(B, per_arm, with_mism, dtype):
    ops = _operands(B, 3, B, 16, 40, per_arm)
    jx = [jnp.asarray(o, dtype=getattr(jnp, dtype)) for o in ops]
    tt = [torch.from_numpy(o).to(getattr(torch, dtype)) for o in ops]
    want_s, want_m = recon_pallas.fused_recon_mse(*jx, 0.1, with_mism)
    got_s, got_m = recon.fused_recon_mse(*tt, 0.1, with_mism)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=RTOL_SUMSQ)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # the plain version against the JAX package's own oracle
    ref_s, ref_m = recon_pallas.recon_mse_reference(*jx, 0.1)
    plain_s, plain_m = recon.recon_mse_reference(*tt, 0.1)
    np.testing.assert_allclose(plain_s.numpy(), np.asarray(ref_s),
                               rtol=RTOL_SUMSQ)
    np.testing.assert_array_equal(plain_m.numpy(), np.asarray(ref_m))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_arm", [False, True])
@pytest.mark.parametrize("B", [16, 520])
def test_fused_recon_grads_match_pallas(B, per_arm, dtype):
    """dh/dW/db of Σ_a g_a·sumsq_a (a per-arm cotangent) against jax.grad
    of the Pallas op, whose vjp runs its fused forward+backward kernel."""
    ops = _operands(B + 1, 3, B, 16, 40, per_arm)
    ga = np.array([0.5, -1.25, 2.0], np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jh, jw, jb, jx = (jnp.asarray(o, jd) for o in ops)

    def f(h, w, b):
        sumsq, mism = recon_pallas.fused_recon_mse(h, w, b, jx, 0.1, True)
        return jnp.sum(jnp.asarray(ga) * sumsq) + 0.0 * jnp.sum(mism)

    want = jax.grad(f, (0, 1, 2))(jh, jw, jb)
    th, tw, tb, tx = (torch.from_numpy(o).to(td) for o in ops)
    for t in (th, tw, tb):
        t.requires_grad_()
    sumsq, mism = recon.fused_recon_mse(th, tw, tb, tx, 0.1, True)
    assert not mism.requires_grad
    (torch.from_numpy(ga) * sumsq).sum().backward()
    want_s, want_m = recon_pallas.fused_recon_mse(jh, jw, jb, jx, 0.1, True)
    np.testing.assert_allclose(sumsq.detach().numpy(), np.asarray(want_s),
                               rtol=RTOL_SUMSQ)
    np.testing.assert_array_equal(mism.numpy(), np.asarray(want_m))
    for t, w_ in zip((th, tw, tb), want):
        assert t.grad.dtype == td
        w_ = np.asarray(w_, np.float32)
        scale = np.abs(w_).max()
        if dtype == "float32":
            np.testing.assert_allclose(t.grad.numpy(), w_, rtol=1e-4,
                                       atol=1e-4 * scale)
        else:
            err = np.abs(t.grad.float().numpy() - w_).max()
            assert err <= 2e-2 * scale, (err, scale)


def test_fwdbwd_plain_version_matches_the_fused_jax_call():
    ops = _operands(5, 2, 37, 8, 24, False)
    out, dh, dw, db = recon_pallas._fwdbwd_call(
        *(jnp.asarray(o) for o in ops), 0.1, True)
    got = recon.recon_fwdbwd(*(torch.from_numpy(o) for o in ops))
    for g_, w_ in zip(got, (out[0], out[1], dh, dw, db)):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-4)


def test_value_only_calls_keep_the_forward_kernel_path():
    """Without a gradient the op takes the value-only path, and under
    autograd the training path; on the CPU neither counts a launch."""
    tt = [torch.from_numpy(o) for o in _operands(4, 2, 8, 4, 12, False)]
    counts = (recon.fused_recon_mse.launches, recon.recon_fwdbwd.launches)
    s0, _ = recon.fused_recon_mse(*tt)
    assert s0.grad_fn is None
    tt[1].requires_grad_()
    s1, _ = recon.fused_recon_mse(*tt)
    assert s1.grad_fn is not None
    with torch.no_grad():
        assert recon.fused_recon_mse(*tt)[0].grad_fn is None
    assert torch.equal(s0, s1.detach())
    assert (recon.fused_recon_mse.launches,
            recon.recon_fwdbwd.launches) == counts


def test_cpu_tensors_take_the_plain_version_without_counting():
    tt = [torch.from_numpy(o) for o in _operands(0, 2, 8, 4, 12, False)]
    before = recon.fused_recon_mse.launches
    s, m = recon.fused_recon_mse(*tt)
    ps, pm = recon.recon_mse_reference(*tt)
    assert recon.fused_recon_mse.launches == before
    assert torch.equal(s, ps) and torch.equal(m, pm)


@pytest.mark.parametrize("bad", ["w_arms", "w_depth", "bias", "x", "rank"])
def test_wrapper_rejects_mismatched_shapes(bad):
    h, w, b, x = (torch.from_numpy(o)
                  for o in _operands(1, 2, 8, 4, 12, False))
    if bad == "w_arms":
        w = w[:1]
    elif bad == "w_depth":
        w = w[:, :3]
    elif bad == "bias":
        b = b[:, :5]
    elif bad == "x":
        x = x[:, :5]
    else:
        h = h[0]
    with pytest.raises(ValueError):
        recon.fused_recon_mse(h, w, b, x)


@pytest.mark.parametrize("case", ["mixed_dtype", "float16", "strided"])
def test_kernel_operand_checks(case):
    ops = [torch.from_numpy(o) for o in _operands(2, 2, 8, 4, 12, False)]
    if case == "mixed_dtype":
        ops[3] = ops[3].to(torch.bfloat16)
    elif case == "float16":
        ops = [o.half() for o in ops]
    else:
        ops[1] = ops[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        _common.check_kernel_operands(("h", "w", "b", "x"), ops)


def test_wrapper_refuses_other_devices():
    ops = [torch.from_numpy(o) for o in _operands(3, 2, 8, 4, 12, False)]
    with pytest.raises(ValueError, match="unsupported device"):
        recon.fused_recon_mse(*[o.to("meta") for o in ops])


def test_build_targets_hopper_and_names_libraries_by_content(monkeypatch,
                                                             tmp_path):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "recon_fwd" in _build.KERNELS
    path = _build.library_path("recon_fwd")
    assert path.parent == _build.BUILD_DIR and path.name.endswith(".so")
    assert path == _build.library_path("recon_fwd")
    # no nvcc here: the builder says so instead of failing obscurely
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


# ---------------------------------------------------------------------------
# Kernel #2's plan on the tensor cores: products, run lengths, slices of D
# ---------------------------------------------------------------------------

from test_torch_encoder import _bf16, _mma_bf16  # noqa: E402
from test_torch_zinb import _mma_3xtf32  # noqa: E402

A_P, B_P, F_P, D_P = 5, 5000, 100, 5032  # the production shape


def _row_plan(A, B, D):
    """(n_split, cols_per_split, row_tiles) of kernel #2's pass 1, the twin
    of ``plan`` in csrc/recon_passes.cuh (64 rows a block, 32 columns a
    step, 264 block slots: an H100 SXM's 132 SMs at two blocks an SM, at
    most 8 slices): D cut into ``n_split`` slices of ``cols_per_split``
    columns so that the (row tiles × A × n_split) blocks fill whole waves
    of the slots, ties to fewer slices, and at most D // B slices beyond
    the first (the dh partials they leave go to the dW buffer).  The chip
    check holds the CUDA plan to its rules and to this twin's plan at the
    two training shapes."""
    row_tiles, chunks, slots = -(-B // 64), -(-D // 32), 132 * 2
    best, n_split = -1.0, 1
    for n in range(1, min(8, chunks, D // B + 1) + 1):
        blocks = row_tiles * A * n
        eff = blocks / (-(-blocks // slots) * slots)
        if eff > best + 1e-9:
            best, n_split = eff, n
    return n_split, -(-chunks // n_split) * 32, row_tiles


def _pad(a, axis, m):
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, (-a.shape[axis]) % m)
    return np.pad(a, widths)


def _plan_operands(dtype, rows, cols, seed):
    """h (rows, F) in [0, 1), W (F, cols) and the bias in ±0.1, x = relu of
    a normal draw (the smoke run's draw), and gm = 2·1[r > 0]·(r − x) from
    the f64 y, rounded to the operand type as the kernel rounds it."""
    r = np.random.default_rng(seed)
    h = r.random((rows, F_P), dtype=np.float32)
    w = ((r.random((F_P, cols)) - 0.5) * 0.2).astype(np.float32)
    b = ((r.random(cols) - 0.5) * 0.2).astype(np.float32)
    x = np.maximum(r.standard_normal((rows, cols)), 0).astype(np.float32)
    if dtype == "bfloat16":
        h, w, b, x = (_bf16(v) for v in (h, w, b, x))
    rr = np.maximum(h.astype(np.float64) @ w + b, 0)
    gm = np.where(rr > 0, 2 * (rr - x), 0).astype(np.float32)
    return h, w, _bf16(gm) if dtype == "bfloat16" else gm


def _plan_product(which, dtype, carry=False):
    """(kernel-order result, a, b) of one of #2's products at production
    depth, summed as recon_passes.cuh sums it.  f32: 3xTF32 mma of 8; y runs
    of 32 in one accumulator, dh one step's 32 columns, dW one step's 32
    rows in two accumulators, each run added rounded to nearest.  bf16: mma
    of 16; y carried through its 7 mma, dh and dW runs of 32.  dh is the
    sum of the slices' partials in slice order.  ``carry``: one
    accumulator carried through every mma instead."""
    f32 = dtype == "float32"
    ks = 8 if f32 else 16

    def model(a, b, run, one_acc=False):
        if f32:
            return _mma_3xtf32(a, b, run=run, carry=carry, one_acc=one_acc)
        return _mma_bf16(a, b, run=run, carry=carry)

    if which == "y = h W (K=F)":
        h, w, _ = _plan_operands(dtype, 64, 64, 41)
        a, b = _pad(h, 1, ks), _pad(w, 0, ks)
        return model(a, b, 32 if f32 else a.shape[1], one_acc=True), a, b
    if which == "dh = gm W^T (K=D)":
        _, w, gm = _plan_operands(dtype, 64, D_P, 43)
        wt = _pad(w.T.copy(), 1, 8)
        if carry:
            return model(gm, wt, 32), gm, wt
        n_split, cols, _ = _row_plan(A_P, B_P, D_P)
        acc = np.zeros((gm.shape[0], wt.shape[1]), np.float32)
        for s in range(n_split):
            sl = slice(s * cols, min(D_P, (s + 1) * cols))
            acc = (acc + model(gm[:, sl], wt[sl], 32)).astype(np.float32)
        return acc, gm, wt
    h, _, gm = _plan_operands(dtype, B_P, 32, 47)
    ht = _pad(h.T.copy(), 0, 16)
    return model(ht, gm, 32), ht, gm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["y = h W (K=F)", "dh = gm W^T (K=D)",
                                   "dW = h^T gm (K=B)"])
def test_plan_keeps_f32_accuracy_at_production_depth(which, dtype):
    """Each product of kernel #2 at its production depth (y over F = 100,
    dh over D = 5,032 in the plan's two slices, dW over B = 5,000), in the
    kernel's split, run lengths and order, with the tensor cores' sums
    rounded toward zero: within 1e-6 of the f64 product (max |Δ| / max
    |f64|), the margin under the chip check's 1e-5 for dh, dW, db and
    sumsq.  Padding rows and columns stay 0."""
    got, a, b = _plan_product(which, dtype)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - exact).max() / np.abs(exact).max() <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["dh = gm W^T (K=D)", "dW = h^T gm (K=B)"])
def test_one_carried_accumulator_misses_at_production_depth(which, dtype):
    """The same products with one accumulator carried through every mma
    (f32: 1,887 for dh, 1,875 for dW; bf16 315 and 313) drift toward zero:
    past the chip check's 1e-5 in f32 and past 3e-6 in bf16, which is why
    the kernel sums runs apart (csrc/mma.cuh ``add4``)."""
    got, a, b = _plan_product(which, dtype, carry=True)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    miss = np.abs(got - exact).max() / np.abs(exact).max()
    assert miss > (1e-5 if dtype == "float32" else 3e-6)


@pytest.mark.parametrize("shape", [(A_P, B_P, D_P), (A_P, 2000, D_P),
                                   (3, 16, 40), (3, 520, 40), (1, 1, 1),
                                   (2, 70000, 5032), (7, 333, 12345)])
def test_row_plan_depends_on_the_shape_alone_and_covers_d_once(shape):
    """The slices of D of #2's pass 1 come from (A, B, D) alone, are whole
    steps of 32 columns, cover [0, D) once and in order, and leave no more
    dh partials beyond dh's own than the dW buffer holds (D // B)."""
    A, B, D = shape
    n_split, cols, row_tiles = _row_plan(A, B, D)
    assert _row_plan(A, B, D) == (n_split, cols, row_tiles)
    assert row_tiles == -(-B // 64) and cols % 32 == 0
    assert 1 <= n_split <= 8 and n_split - 1 <= D // B
    covered = np.concatenate([np.arange(D)[s * cols:(s + 1) * cols]
                              for s in range(n_split)])
    np.testing.assert_array_equal(covered, np.arange(D))


def test_row_plan_fills_whole_waves_at_the_production_shape():
    """A=5, B=5000, D=5032: 79 row tiles × 5 arms in 2 slices of 2,528
    columns are 790 blocks, 3 waves of 264 slots all but 2 full; the 2,000-
    row tail takes 3 slices (480 blocks on 528 slots)."""
    assert _row_plan(A_P, B_P, D_P) == (2, 2528, 79)
    assert _row_plan(A_P, 2000, D_P) == (3, 1696, 32)
