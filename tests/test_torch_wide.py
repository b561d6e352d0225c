"""Hidden widths past 128 (fault C6): the port's fused ops against the JAX
package's Pallas kernels at F = 160, the trainer at ``fc_dim=160``, and
Python twins of the plans by which the CUDA kernels walk such a width in
chunks of 128 (csrc/recon_passes.cuh, csrc/zinb_rows.cuh and
csrc/zinb_fwdbwd.cu, csrc/decoder.cu).

The JAX kernels put no bound on F (recon_pallas ``_fwdbwd_call`` blocks W
as (1, F, D) whole); they run here in interpret mode, as the JAX tests run
them.  On CPU tensors the port's wrappers run their plain versions; the
CUDA kernels are held against those on the card by chip_smoke.py (phase 2,
``c6``).  Same inputs, made with numpy from a seed, go to both sides.
Tolerances: values rtol 1e-5 (f32 sums in another order), gradients within
1e-4 of each gradient's largest entry (sums over up to 160 units or 40
columns of products, in another order, and for ZINB the interpreted
kernel's division by a reciprocal with a Newton step).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvae_tpu.ops import decoder_pallas, recon_pallas, zinb_pallas
from dvae_tpu_torch.data.anndata_io import synthetic_dataset
from dvae_tpu_torch.ops import decoder, recon, zinb
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE

F_WIDE = 160
VALUE = 1e-5
GRAD = 1e-4
GA = np.array([0.5, -1.25], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close_to_max(got, want, tol, msg=""):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * np.abs(want).max(), (msg, err, np.abs(want).max())


def _recon_operands(seed, A=2, B=24, F=F_WIDE, D=40):
    r = np.random.default_rng(seed)
    h = r.random((A, B, F), dtype=np.float32)
    w = ((r.random((A, F, D)) - 0.5) * 0.2).astype(np.float32)
    b = ((r.random((A, D)) - 0.5) * 0.2).astype(np.float32)
    x = np.maximum(r.normal(size=(B, D)), 0.0).astype(np.float32)
    return [h, w, b, x]


def _zinb_operands(seed, A=2, B=24, F=F_WIDE, D=40):
    r = np.random.default_rng(seed)
    out = [(r.normal(size=(A, B, F)) / np.sqrt(F / 16)).astype(np.float32)]
    for _ in range(3):
        out += [0.1 * r.normal(size=(A, F, D)).astype(np.float32),
                0.1 * r.normal(size=(A, D)).astype(np.float32)]
    out.append((np.maximum(r.normal(0.8, 1, (B, D)), 0)
                * (r.random((B, D)) > 0.5)).astype(np.float32))
    return out


def _decoder_operands(seed, A=2, B=24, Z=10, L=6, F=F_WIDE, D=40):
    r = np.random.default_rng(seed)
    args = [(0.3 * r.normal(size=(A, B, Z))).astype(np.float32)]
    for k, n in ((Z, L), (L, F), (F, F), (F, F), (F, F), (F, D)):
        args += [(r.normal(size=(A, k, n)) / np.sqrt(k)).astype(np.float32),
                 (0.1 * r.normal(size=(A, n))).astype(np.float32)]
    args.append(np.maximum(r.normal(0.5, 1, (B, D)), 0).astype(np.float32))
    return args


# (the port's op, the JAX op, the operands, how many take a gradient)
WIDE_OPS = {
    "recon": (lambda *a: recon.fused_recon_mse(*a, 0.1, True)[0],
              lambda *a: recon_pallas.fused_recon_mse(*a, 0.1, True)[0],
              _recon_operands, 3),
    "zinb": (lambda *a: zinb.fused_zinb(*a, 1e-6),
             lambda *a: zinb_pallas.fused_zinb(*a, 1e-6),
             _zinb_operands, 7),
    "decoder": (lambda *a: decoder.fused_decoder_mse(*a, 0.1, True)[0],
                lambda *a: decoder_pallas.fused_decoder_mse(*a, 0.1, True)[0],
                _decoder_operands, 13),
}


@pytest.mark.parametrize("op", sorted(WIDE_OPS))
def test_fused_op_at_f160_matches_the_pallas_kernel(op):
    """Value and every gradient of Σ_a g_a·loss_a (a per-arm cotangent) at
    F = 160 against the TPU kernel (its fused forward+backward under
    jax.grad), interpreted."""
    port, jax_op, operands, n_diff = WIDE_OPS[op]
    args = operands(7)
    jx = [jnp.asarray(a) for a in args]
    want = np.asarray(jax_op(*jx))
    want_g = jax.grad(lambda *d: jnp.sum(jnp.asarray(GA) * jax_op(
        *d, *jx[n_diff:])), tuple(range(n_diff)))(*jx[:n_diff])
    tt = [torch.from_numpy(a) for a in args]
    for t in tt[:n_diff]:
        t.requires_grad_()
    got = port(*tt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=VALUE)
    (torch.from_numpy(GA) * got).sum().backward()
    for i, (t, w_) in enumerate(zip(tt[:n_diff], want_g)):
        assert t.grad.shape == t.shape
        _close_to_max(t.grad.numpy(), w_, GRAD, f"{op} operand {i}")


@pytest.mark.parametrize("mode", ["MSE", "ZINB", "fused_decoder"])
def test_init_model_at_fc_dim_160_trains_one_step(mode, tmp_path):
    """init_model(fc_dim=160) with the fused ops taken (their plain
    versions on the CPU) takes one finite Adam step in each mode."""
    x = synthetic_dataset(32, 40, 5, seed=4).log1p
    if mode == "ZINB":
        x = np.round(x * 2) / 2
    cpl = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=1)
    kw = {"mode": "ZINB"} if mode == "ZINB" else (
        {"fused_decoder": True} if mode == "fused_decoder" else {})
    cpl.init_model(n_arm=2, input_dim=40, fc_dim=F_WIDE, lowD_dim=6,
                   n_categories=5, state_dim=2, batch_size=32,
                   epochs_per_jit=1, fused=True, **kw)
    assert cpl.cfg.fused_recon and cpl.cfg.fc_dim == F_WIDE
    assert cpl.cfg.fused_decoder == (mode == "fused_decoder")
    before = {k: {n: v.clone() for n, v in layer.items()}
              for k, layer in cpl.state.params.items()}
    cpl.train(x, n_epoch=1, early_stop_consensus=0, save_plots=False)
    assert cpl.state.opt_state.count == 1
    fc1 = cpl.state.params["fc1"]["w"]
    assert fc1.shape[-1] == F_WIDE
    moved = [not torch.equal(v, before[k][n])
             for k, layer in cpl.state.params.items()
             for n, v in layer.items()]
    assert all(bool(torch.isfinite(v).all())
               for layer in cpl.state.params.values() for v in layer.values())
    assert sum(moved) > len(moved) // 2


# ---------------------------------------------------------------------------
# Python twins of the kernels' plans for a hidden width F
# ---------------------------------------------------------------------------

SMEM_MAX = 232448           # dynamic shared memory a block may take
FP, KC = 128, 128           # widest resident F; the wide forms' chunk
KS = {"float32": 8, "bfloat16": 16}
ITEM = {"float32": 4, "bfloat16": 2}


def _fk(F, dt):
    return -(-F // KS[dt]) * KS[dt]


def _chunks(F, dt):
    """The K chunks of the wide forms: [start, end) over F's padded depth."""
    fk = _fk(F, dt)
    return [(k, min(fk, k + KC)) for k in range(0, fk, KC)]


def recon_plan(F, dt, dh=True):
    """csrc/recon_passes.cuh for a hidden width F: the form, the dh/dW
    chunks of the grid's z axis and the two passes' shared memory."""
    hpad = 4 if dt == "float32" else 8
    ldw1, ldx1, ldw2, ldx2 = 40, 40, 72, 72
    ldg = 68 if dt == "float32" else 72
    stages2 = 3 if dt == "float32" else 4
    fk, e = _fk(F, dt), ITEM[dt]
    wide = F > FP
    if wide:
        rows = e * (64 * (fk + hpad) + 2 * (KC * ldw1 + 64 * ldx1))
        cols = e * (fk * ldw2 + 2 * 64 * (KC + hpad) + 64 * ldg)
        ft = 16
    else:
        ft = 13 if F <= 104 else 16
        hc = -(-8 * ft // 16) * 16
        rows = e * (64 * (fk + hpad) + 2 * (fk * ldw1 + 64 * ldx1))
        cols = e * (fk * ldw2 + stages2 * 64 * (hc + hpad + ldx2)
                    + 64 * ldg)
    return {"wide": wide, "ft": ft,
            "chunks": _chunks(F, dt) if wide else [(0, fk)],
            "z_chunks": len(_chunks(F, dt)) if wide and dh else 1,
            "smem_rows": rows + 64, "smem_cols": cols if dh else 0}


def zinb_plan(F, dt, dh=True):
    """csrc/zinb_rows.cuh and csrc/zinb_fwdbwd.cu for a hidden width F.
    The column pass (the wgmma product over the stored cotangents) takes
    the same shared memory at every F: 1,024 bytes of alignment and its
    ring of stages, each three 64 x 32 f32 tiles of g and one 104 x 32
    tile of hᵀ (tf32 hi and lo in f32)."""
    f32 = dt == "float32"
    hpad = 4 if f32 else 8
    ldw1 = ldx1 = 8 if f32 else 24
    fk, e = _fk(F, dt), ITEM[dt]
    wide = F > FP
    kw = KC if wide else fk
    stages = 2 if (dh or wide) else 1
    rows = e * (64 * (fk + hpad) + stages * (3 * kw * ldw1 + 64 * ldx1))
    stage = -(-(3 * 64 * 32 * 4 + (2 if f32 else 1) * 104 * 32 * e)
              // 1024) * 1024
    cols = 1024 + min(6, (225 * 1024 - 1024) // stage) * stage
    return {"wide": wide, "chunks": _chunks(F, dt) if wide else [(0, fk)],
            "smem_rows": rows + 64, "smem_cols": cols if dh else 0}


def _limit(plan, dt, dh):
    f = FP
    while True:
        p = plan(f + KS[dt], dt, dh)
        if max(p["smem_rows"], p["smem_cols"]) > SMEM_MAX:
            return f
        f += KS[dt]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [100, 160, 448])
@pytest.mark.parametrize("plan", [recon_plan, zinb_plan])
def test_chunk_plans_cover_f_once_and_fit_shared_memory(plan, F, dt):
    """Chunks of at most 128 cover [0, F) once and in order; F <= 128 keeps
    the resident form (one chunk, F = 100 in 13 tiles of 8: PR 10's plan);
    both passes fit a block's shared memory, with dh and without."""
    for dh in (True, False):
        p = plan(F, dt, dh)
        assert p["wide"] == (F > 128)
        starts = [a for a, _ in p["chunks"]]
        assert starts == list(range(0, _fk(F, dt), 128))
        assert all(0 < b - a <= 128 for a, b in p["chunks"])
        assert p["chunks"][-1][1] == _fk(F, dt) >= F
        assert max(p["smem_rows"], p["smem_cols"]) <= SMEM_MAX
    if F <= 128:
        assert len(plan(F, dt)["chunks"]) == 1
    if plan is recon_plan and F == 100:
        # PR 10's pass-1 plan at the production width: 13 tiles of 8
        assert recon_plan(F, dt)["ft"] == 13


@pytest.mark.parametrize("plan, want", [
    (recon_plan, {("float32", True): 512, ("bfloat16", True): 1296,
                  ("float32", False): 656, ("bfloat16", False): 1552}),
    (zinb_plan, {("float32", True): 784, ("bfloat16", True): 1456,
                 ("float32", False): 784, ("bfloat16", False): 1456})])
def test_width_limits_the_shared_memory_sets(plan, want):
    """The widest F whose wide forms fit a block, with dh (the training
    kernels) and without (the value-only ones): at least 512 everywhere,
    the numbers the kernels' sources state and chip_smoke.py reads back."""
    got = {(dt, dh): _limit(plan, dt, dh) for dt, dh in want}
    assert got == want and min(got.values()) >= 512


def decoder_plan(widths):
    """csrc/decoder.cu for widths [Z, out_6..out_10]: the wide trunk past
    an output of 128, its chunks of every layer's inputs and outputs, and
    the sizes of its workspaces in elements (A = B = 1)."""
    wmax = max(widths[1:])
    wide = wmax > 128
    layers = list(zip(widths[:-1], widths[1:]))
    return {"wide": wide,
            "k_chunks": [len(range(0, k, KC)) for k, _ in layers],
            "n_chunks": [len(range(0, n, KC)) for _, n in layers],
            "acts": sum(widths[1:]) if wide else widths[-1],
            "g_buffers": 2 * wmax if wide else None}


@pytest.mark.parametrize("F", [100, 160, 448])
def test_decoder_trunk_plan(F):
    """Trunk widths past 128 take the wide trunk: every layer walked in
    chunks of 128 of its inputs and outputs, all five activations kept (the
    value-only call's too) and two g buffers of the widest output in place
    of the per-row-tile gradient partials; F = 100 keeps PR 10's trunk."""
    p = decoder_plan([94, 10, F, F, F, F])
    assert p["wide"] == (F > 128)
    assert p["k_chunks"] == [1, 1] + [-(-F // 128)] * 3
    assert p["n_chunks"] == [1] + [-(-F // 128)] * 4
    if p["wide"]:
        assert p["acts"] == 10 + 4 * F and p["g_buffers"] == 2 * F
    else:
        assert p["acts"] == F and p["g_buffers"] is None
