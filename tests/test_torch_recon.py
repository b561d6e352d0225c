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
