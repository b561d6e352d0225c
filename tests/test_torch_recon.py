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
from test_torch_zinb import _mma_3xtf32, _rz  # noqa: E402

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


def _tf32_rna(a):
    """``a`` rounded to tf32 as cvt.rna rounds it: to nearest, ties away
    from zero (the integer form of csrc/mma.cuh ``tf32_bits``)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u.astype(np.uint64) + 0x1000) & 0xFFFFE000).astype(
        np.uint32).view(np.float32)


def _wgmma_3xtf32(a, b):
    """a @ b as kernel #1 forms it (csrc/recon_fwd.cu): both operands split
    once by the prep into tf32 halves (cvt.rna), K zero-padded to the k of
    one product; per k step of 8 (one m64n64k8 product each, exact
    products summed with the accumulator and rounded toward zero) hi·hi
    joins one accumulator and lo·hi, then hi·lo, another, both carried
    over every step of the chunk (13 at F = 104) without a run summed
    apart; y = big + small rounded to nearest."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    big = np.zeros((a.shape[0], b.shape[1]), np.float32)
    small = np.zeros_like(big)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        f64 = lambda u, v: u[:, k].astype(np.float64) @ v[k]  # noqa: E731
        big = _rz(big + f64(a_hi, b_hi))
        small = _rz(small + f64(a_lo, b_hi))
        small = _rz(small + f64(a_hi, b_lo))
    return (big + small).astype(np.float32)


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
    if which == "y of #1 = h W (K=F, wgmma)":
        h, w, _ = _plan_operands(dtype, 64, 64, 49)
        a, b = _pad(h, 1, ks), _pad(w, 0, ks)
        if carry or not f32:
            return model(a, b, a.shape[1]), a, b
        return _wgmma_3xtf32(a, b), a, b
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
                                   "dW = h^T gm (K=B)",
                                   "y of #1 = h W (K=F, wgmma)"])
def test_plan_keeps_f32_accuracy_at_production_depth(which, dtype):
    """Each product of kernel #2 at its production depth (y over F = 100,
    dh over D = 5,032 in the plan's two slices, dW over B = 5,000), and
    kernel #1's y on wgmma (``_wgmma_3xtf32``; bf16: 7 products of k 16
    carried in one accumulator), in the kernel's split, run lengths and
    order, with the tensor cores' sums rounded toward zero: within 1e-6 of
    the f64 product (max |Δ| / max |f64|), the margin under the chip
    check's 1e-5 for dh, dW, db and sumsq.  Padding rows and columns stay
    0."""
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


# ---------------------------------------------------------------------------
# Fault C5: a NaN of x reaches gm, and through it dh, dW and db
# ---------------------------------------------------------------------------

def _nan_of_x_operands(per_arm, live, dtype, seed=11):
    """The operands of the file's draw (A=3, B=16, F=16, D=40) with x NaN
    at one element (i, j): where arm 1's y lies clear of 0 above it
    (``live``: r > 0, so gm is NaN there) or, with shared x, where every
    arm's y lies clear of 0 below it (r = 0 and gm = 0 in every arm that
    reads it)."""
    h, w, b, x = _operands(seed, 3, 16, 16, 40, per_arm)
    if dtype == "bfloat16":
        h, w, b, x = (_bf16(v) for v in (h, w, b, x))
    y = np.einsum("abf,afd->abd", h.astype(np.float64), w) + b[:, None, :]
    ok = (y[1] > 0.05) if live else (
        (y < -0.05).all(axis=0) if not per_arm else y[1] < -0.05)
    i, j = map(int, np.argwhere(ok)[0])
    x = x.copy()
    x[(1, i, j) if per_arm else (i, j)] = np.nan
    return (h, w, b, x), i, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("live", [True, False])
@pytest.mark.parametrize("per_arm", [False, True])
def test_nan_of_x_gives_the_pallas_kernels_nan_pattern(per_arm, live, dtype):
    """A NaN of x: the sums of every arm that reads it NaN, and where that
    arm's r > 0 (gm = 2 (r - x) NaN) its dh row, dW column and db entry;
    where r = 0 gm is 0 and the gradients stay finite.  The JAX package's
    gradient (its fused backward, interpreted) and the port's plain
    version give NaN at the same places (``assert_allclose`` holds NaN to
    NaN) and agree elsewhere within the file's tolerances."""
    (h, w, b, x), i, j = _nan_of_x_operands(per_arm, live, dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jh, jw, jb, jx = (jnp.asarray(o, jd) for o in (h, w, b, x))
    want_s, want_m = recon_pallas.fused_recon_mse(jh, jw, jb, jx, 0.1, True)
    want = jax.grad(lambda *a: jnp.sum(recon_pallas.fused_recon_mse(
        *a, jx, 0.1, True)[0]), (0, 1, 2))(jh, jw, jb)
    got = recon.recon_fwdbwd(*(torch.from_numpy(o).to(td)
                               for o in (h, w, b, x)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_s),
                               rtol=RTOL_SUMSQ)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_m))
    for g_, w_ in zip(got[2:], want):
        w_ = np.asarray(w_, np.float32)
        scale = np.nanmax(np.abs(w_))
        rtol, atol = (1e-4, 1e-4 * scale) if dtype == "float32" \
            else (0.0, 2e-2 * scale)
        np.testing.assert_allclose(g_.float().numpy(), w_, rtol=rtol,
                                   atol=atol)
    dh, dw, db = (t.float().numpy() for t in got[2:])
    assert np.isnan(got[0].numpy()[1])
    if per_arm:
        assert np.isfinite(got[0].numpy()[[0, 2]]).all()
    if live:
        assert np.isnan(dh[1, i]).all() and np.isnan(dw[1, :, j]).all()
        assert np.isnan(db[1, j])
        rows, cols = np.isnan(dh).any(axis=2), np.isnan(db)
        assert rows.sum() == cols.sum() <= 3 and not rows[:, np.arange(16)
                                                          != i].any()
    else:
        assert all(np.isfinite(t).all() for t in (dh, dw, db))


# ---------------------------------------------------------------------------
# Kernel #1 on wgmma: its launch plan and workspace, and its products
# ---------------------------------------------------------------------------

def _fwd_plan(A, B, F, D, dtype):
    """(k chunk, chunks, row blocks, column tiles, slices of D, column
    tiles a slice, stages, x staged, shared memory bytes) of kernel #1,
    the twin of ``make_plan`` in csrc/recon_fwd.cu: k in steps of one
    product (8 tf32, 16 bf16); one chunk while a row of it takes at most
    832 bytes over its planes (f32: hi and lo), then chunks of at most 512;
    128-row blocks and 64-column tiles; D cut into slices of whole tiles so
    that the blocks (A x row blocks x slices) fill whole waves of 132 slots
    most evenly, counted in tiles, ties to fewer, no empty slice, at most
    8; x tiles (128 rows at a pitch of 72) staged in the ring when x's rows
    are whole 16-byte runs and two such stages fit; as many ring stages (at
    most 4) as 225 KiB hold beside the resident h tile."""
    planes, ks, item = (2, 8, 4) if dtype == "float32" else (1, 16, 2)
    e = planes * item
    fk = -(-F // ks) * ks
    if fk * e <= 832:
        nk, kc = 1, fk
    else:
        nk = -(-fk // (512 // e))
        kc = -(-(-(-fk // nk)) // ks) * ks
    rt, ct = -(-B // 128), -(-D // 64)
    best, n_split = -1.0, 1
    for s in range(1, min(8, ct) + 1):
        per = -(-ct // s)
        if (s - 1) * per >= ct:
            continue
        waves = -(-(A * rt * s) // 132)
        eff = A * rt * ct / (waves * 132 * per)
        if eff > best + 1e-9:
            best, n_split = eff, s
    tb = 64 * kc * planes * item
    fixed, stage = (2 * tb, tb) if nk == 1 else (0, 3 * tb)
    xs = int(D * item % 16 == 0)
    if xs and (225 * 1024 - fixed) // (stage + 128 * 72 * item) < 2:
        xs = 0
    stage += xs * 128 * 72 * item
    stages = min(4, (225 * 1024 - fixed) // stage)
    return kc, nk, rt, ct, n_split, -(-ct // n_split), stages, xs, \
        fixed + stages * stage


def _fwd_workspace_bytes(A, B, F, D, dtype):
    """Bytes of #1's workspace: h as 64-row tiles (rows padded to the
    block's 128) and W^T as 64-column tiles, every chunk and plane, then
    the double and 64-bit partials, each at a multiple of 256 bytes."""
    kc, nk, rt, ct, n_split = _fwd_plan(A, B, F, D, dtype)[:5]
    item, planes = (4, 2) if dtype == "float32" else (2, 1)
    up = lambda n: -(-n // 256) * 256  # noqa: E731
    tile = 64 * kc * planes * item
    n_part = A * rt * n_split
    return (up(A * nk * 2 * rt * tile) + up(A * nk * ct * tile)
            + 2 * up(8 * n_part))


def test_fwd_plan_at_the_production_shape():
    """A=5, B=5000, F=100, D=5032: one chunk (k 104 f32, 112 bf16), 40 row
    blocks x 79 column tiles in 5 slices of 16 (1,000 blocks on 8 waves of
    132: 0.935 of the slots), two stages beside the 106,496-byte h tile
    in f32 with x read by the epilogue (a staged x tile would leave room
    for one), four in bf16 with x staged; the chip check holds the CUDA
    plan to these.
    The workspace is 42.3 MB in f32, under one (A,B,D) f32 tensor."""
    assert _fwd_plan(A_P, B_P, F_P, D_P, "float32") == \
        (104, 1, 40, 79, 5, 16, 2, 0, 212992)
    assert _fwd_plan(A_P, B_P, F_P, D_P, "bfloat16") == \
        (112, 1, 40, 79, 5, 16, 4, 1, 159744)
    assert _fwd_workspace_bytes(A_P, B_P, F_P, D_P, "float32") == 42348544
    assert _fwd_workspace_bytes(A_P, B_P, F_P, D_P, "float32") \
        < A_P * B_P * D_P * 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(A_P, B_P, F_P, D_P), (A_P, 2000, F_P, D_P),
                                   (3, 300, 37, 1000), (3, 300, 160, 1000),
                                   (5, 130, 448, 517), (1, 1, 1, 1),
                                   (2, 2000, F_P, 5031)])
def test_fwd_plan_covers_the_shape_within_the_cards_limits(shape, dtype):
    """Every F is taken (k chunks cover it), the slices cover D's tiles
    once with none empty, the grid stays within its limits and the shared
    memory within a block's 227 KB with at least two stages."""
    A, B, F, D = shape
    kc, nk, rt, ct, n_split, tiles, stages, xs, smem = _fwd_plan(
        A, B, F, D, dtype)
    ks = 8 if dtype == "float32" else 16
    assert kc % ks == 0 and nk * kc >= F and (nk - 1) * kc < F
    assert rt == -(-B // 128) <= 65535 and ct == -(-D // 64)
    assert 1 <= n_split <= 8 and (n_split - 1) * tiles < ct <= n_split * tiles
    assert 2 <= stages <= 4 and smem <= 225 * 1024
    assert xs == 0 or D * (4 if dtype == "float32" else 2) % 16 == 0


def _prep_split(v):
    """The prep's split of f32 values (csrc/recon_fwd.cu
    ``recon_fwd_prep``): every NaN made the quiet 0x7FC00000 first
    (tc::quiet_nan), then hi = rna(v) and lo = rna(v - hi)."""
    v = np.asarray(v, np.float32)
    v = np.where(np.isnan(v), np.uint32(0x7FC00000).view(np.float32), v)
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0x7FC00000])
def test_prep_split_keeps_every_nan(bits):
    """Both NaN encodings stay NaN through the prep's split, as the tf32
    bits the tensor cores read (the top 19); rounding the card's own NaN
    without the quiet step carries into the sign and gives -0 (fault C5's
    mechanism), which is why the prep makes a NaN quiet first."""
    v = np.array([bits, 0x3F800001, 0xBF7FFFFF], np.uint32).view(np.float32)
    hi, lo = _prep_split(v)
    tf32 = lambda a: (a.view(np.uint32) & 0xFFFFE000).view(np.float32)  # noqa: E731
    assert np.isnan(tf32(hi[0])) and np.isnan(tf32(lo[0]))
    np.testing.assert_array_equal(hi[1:].astype(np.float64)
                                  + lo[1:].astype(np.float64), v[1:])
    raw = _tf32_rna(v[:1]).view(np.uint32)[0]
    assert (raw == 0x80000000) == (bits == 0x7FFFFFFF)
