"""The frozen augmenter's fused layer (dvae_tpu_torch/ops/augment.py) on the
CPU: its plain version against the augmenter's own layer (``_lin`` →
``_bn`` → ReLU), the tf32 split and the weight layout the kernel
(csrc/augment_fc.cu) reads, the cache of prepared weights, and
``augment_arms``: its CPU path bit for bit the plain code it has always
run, and its CUDA path (``_fused_layer``: aligned rows, the draws' order,
the mask, one launch a layer of ``FUSED_LAYERS``) run here through the
plain version of the kernel.

The kernel itself runs only on the card: ``chip_smoke.py`` phase 7 holds it
to the plain version and to float64.
"""

import pytest
import torch

from dvae_tpu_torch.augment import augmenter as aug
from dvae_tpu_torch.ops import augment as fc_op

SMALL = dict(input_dim=70, n_dim=30, noise_dim=6, latent_dim=4)
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _stats(g, n: int) -> dict:
    return {"mean": torch.randn(n, generator=g) / 4,
            "var": 0.5 + torch.rand(n, generator=g)}


def _grid(g, shape, scale: int, dtype) -> torch.Tensor:
    """Small multiples of 1/scale: every product and every sum of the tests'
    depths is exact in f32 (and the values exact in bf16)."""
    return (torch.randint(-8, 9, shape, generator=g).float() / scale).to(dtype)


def _plain_layer(x, w, b, stats, eps):
    """The augmenter's layer as augment/augmenter.py computes it."""
    y = aug._lin({"w": w, "b": b}, x)
    if stats is not None:
        y, _ = aug._bn(y, stats, False, eps)
    return torch.relu(y)


# ---------------------------------------------------------------------------
# The plain version against the augmenter's layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("norm", [False, True])
def test_plain_version_is_the_augmenters_layer(norm, bias, dtype):
    """On a grid where every product is exact the plain version of the
    kernel (3xTF32 stage runs for f32, the padded K, the epilogue in its
    order) equals ``_lin`` → ``_bn`` → ReLU bit for bit, with or without
    the bias and the batch norm."""
    g = torch.Generator().manual_seed(3)
    M, K, N = 37, 70, 45
    x = _grid(g, (M, K), 8, dtype)
    w = _grid(g, (K, N), 16, dtype)
    b = _grid(g, (N,), 4, dtype) if bias else None
    stats = _stats(g, N) if norm else None
    got = fc_op.augment_fc_reference(x, w, b, stats, 1e-5)
    want = _plain_layer(x, w, b, stats, 1e-5)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("K", [5032, 1006, 550, 500, 100, 10])
def test_plain_version_is_the_layer_within_f32_rounding(K):
    """Off the grid the 3xTF32 products of the plain version stay within
    f32 rounding of the f32 product, at every depth of the augmenter's
    routed layers (fc1 5032, fc2 and fc11 1006, fc5 550, fc4 500, fc7
    100, fc6 10)."""
    g = torch.Generator().manual_seed(4)
    M, N = 16, 40
    x = torch.relu(torch.randn((M, K), generator=g))
    w = (2 * torch.rand((K, N), generator=g) - 1) / K ** 0.5
    b = torch.randn(N, generator=g) / 8
    stats = _stats(g, N)
    got = fc_op.augment_fc_reference(x, w, b, stats, 1e-10)
    want = _plain_layer(x, w, b, stats, 1e-10)
    assert (got - want).abs().max() <= 2e-6 * want.abs().max()


def test_plain_version_without_bias_or_norm_and_with_the_mask():
    """fc11 of a ZINB augmenter: bias and ReLU, then row r times
    (mask[r % R] > 0); no bias and no batch norm leave those steps out."""
    g = torch.Generator().manual_seed(5)
    R, K, N = 6, 20, 9
    x = _grid(g, (3 * R, K), 8, torch.float32)
    w = _grid(g, (K, N), 16, torch.float32)
    b = _grid(g, (N,), 4, torch.float32)
    mask = torch.relu(_grid(g, (R, N), 2, torch.float32))
    got = fc_op.augment_fc_reference(x, w, b, None, 0.0, mask=mask)
    want = torch.relu(x @ w + b) * (mask.repeat(3, 1) > 0)
    assert torch.equal(got, want)
    assert torch.equal(fc_op.augment_fc_reference(x, w), torch.relu(x @ w))


@pytest.mark.parametrize("bits", [0x7FC00000, 0x7FFFFFFF])
@pytest.mark.parametrize("where", ["x", "w"])
def test_plain_version_keeps_a_nan(where, bits):
    """A NaN of either encoding in x (row 3) or W (column 5) makes that
    row or column of the output NaN, through the split, the product and the
    ReLU; every other output is the clean case's."""
    g = torch.Generator().manual_seed(15)
    M, K, N = 9, 40, 11
    x = _grid(g, (M, K), 8, torch.float32)
    w = _grid(g, (K, N), 16, torch.float32)
    b = _grid(g, (N,), 4, torch.float32)
    clean = fc_op.augment_fc_reference(x, w, b)
    t = (x if where == "x" else w).clone()
    t.view(torch.int32)[3 if where == "x" else 7,
                        7 if where == "x" else 5] = bits
    got = (fc_op.augment_fc_reference(t, w, b) if where == "x"
           else fc_op.augment_fc_reference(x, t, b))
    want = torch.zeros((M, N), dtype=torch.bool)
    if where == "x":
        want[3] = True
    else:
        want[:, 5] = True
    assert torch.equal(torch.isnan(got), want)
    assert torch.equal(got[~want], clean[~want])


# ---------------------------------------------------------------------------
# The tf32 split and the layout of the prepared weights
# ---------------------------------------------------------------------------

def test_split_rebuilds_the_weight_and_keeps_both_nans():
    g = torch.Generator().manual_seed(6)
    w = torch.randn(4096, generator=g) * torch.exp2(
        torch.randint(-30, 30, (4096,), generator=g).float())
    hi, lo = fc_op.split_tf32(w)
    assert ((_bits(hi) & 0x1FFF) == 0).all() and ((_bits(lo) & 0x1FFF) == 0).all()
    assert ((hi + lo - w).abs() <= 2.0 ** -22 * w.abs()).all()
    nans = torch.tensor([0x7FC00000, 0x7FFFFFFF, -0x400000, 0x7F800001],
                        dtype=torch.int32).view(torch.float32)
    hi, lo = fc_op.split_tf32(nans)
    assert torch.isnan(hi).all() and torch.isnan(lo).all()
    inf = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(fc_op.tf32_round(inf), inf)


def test_tf32_rounding_is_to_nearest_with_ties_away():
    """The ties of cvt.rna: half a tf32 unit rounds away from zero, just
    under half rounds down, and a carry runs into the exponent."""
    bits = torch.tensor([0x3F801000, 0x3F800FFF, 0xBF801000 - (1 << 32),
                         0x3FFFF000, 0x3F803000], dtype=torch.int64)
    x = bits.to(torch.int32).view(torch.float32)
    want = torch.tensor([0x3F802000, 0x3F800000, 0xBF802000 - (1 << 32),
                         0x40000000, 0x3F804000], dtype=torch.int64)
    assert torch.equal(_bits(fc_op.tf32_round(x)), want & 0xFFFFFFFF)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k_order_gives_a_thread_consecutive_columns(dtype):
    """k_order is a permutation of a stage, and the A fragment that the
    kernel builds from a thread's consecutive columns (registers v[2 s] and
    v[2 s + 1] of k step s) holds the K positions wgmma's fragment asks
    for: f32 (t, t + 4) of k step s, bf16 the pairs (2 t, 2 t + 1) and
    (2 t + 8, 2 t + 9)."""
    order = fc_op.k_order(dtype)
    kt = fc_op.k_tile(dtype)
    assert sorted(order) == list(range(kt))
    pos = {col: k for k, col in enumerate(order)}   # column -> K position
    for t in range(4):
        for s in range(4):
            if dtype == torch.float32:
                cols = [8 * t + 2 * s, 8 * t + 2 * s + 1]
                assert [pos[c] for c in cols] == [8 * s + t, 8 * s + t + 4]
            else:
                pairs = [(16 * t + 4 * s, 16 * t + 4 * s + 1),
                         (16 * t + 4 * s + 2, 16 * t + 4 * s + 3)]
                assert [[pos[c] for c in p] for p in pairs] == [
                    [16 * s + 2 * t, 16 * s + 2 * t + 1],
                    [16 * s + 2 * t + 8, 16 * s + 2 * t + 9]]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(70, 150), (10, 100), (1006, 130)])
def test_prepared_weight_layout(shape, dtype):
    """Every element of the prepared weight, by the layout the kernel's
    descriptors read: tile (column tile j, stage c, plane p) of 128 × KT,
    core matrices of 8 rows × 16 bytes, K-major, the stage's K order
    permuted; zeros past K and N; f32 as hi then lo."""
    K, N = shape
    g = torch.Generator().manual_seed(7)
    w = torch.randn((K, N), generator=g).to(dtype)
    wp = fc_op.prepare_weight(w)
    kt, e = fc_op.k_tile(dtype), 16 // w.element_size()
    nk, nt = -(-K // kt), -(-N // fc_op.BN)
    planes = ([t.to(dtype) for t in fc_op.split_tf32(w.float())]
              if dtype == torch.float32 else [w])
    P = len(planes)
    assert wp.numel() == nt * nk * P * fc_op.BN * kt and wp.dtype == dtype
    order = torch.tensor(fc_op.k_order(dtype))
    n = torch.arange(fc_op.BN)[:, None]
    k = torch.arange(kt)[None, :]
    inner = ((n // 8) * (kt // e) + k // e) * 8 * e + (n % 8) * e + k % e
    for j in range(nt):
        for c in range(nk):
            for p in range(P):
                base = ((j * nk + c) * P + p) * fc_op.BN * kt
                tile = wp[base + inner]                      # (n, k)
                rows = c * kt + order                        # W's rows
                cols = j * fc_op.BN + torch.arange(fc_op.BN)
                want = torch.zeros((fc_op.BN, kt), dtype=dtype)
                r_ok, c_ok = rows < K, cols < N
                want[c_ok[:, None] & r_ok[None, :]] = planes[p][
                    rows[r_ok][None, :], cols[c_ok][:, None]].reshape(-1)
                assert torch.equal(tile, want)


def test_prepared_weights_follow_an_in_place_change():
    g = torch.Generator().manual_seed(8)
    w = torch.randn((70, 40), generator=g)
    first = fc_op.prepared(w)
    assert fc_op.prepared(w) is first
    w.mul_(2.0)
    second = fc_op.prepared(w)
    assert second is not first
    assert torch.equal(second, fc_op.prepare_weight(w))
    assert torch.equal(second, 2 * first)
    stats = {"mean": torch.zeros(4), "var": torch.ones(4)}
    r = fc_op.running_rstd(stats, 1e-5)
    assert fc_op.running_rstd(stats, 1e-5) is r
    assert fc_op.running_rstd(stats, 1e-3) is not r
    stats["var"].add_(3.0)
    assert torch.equal(fc_op.running_rstd(stats, 1e-5),
                       torch.rsqrt(stats["var"] + 1e-5))


def test_cache_entries_go_with_their_tensors():
    w = torch.randn((33, 17))
    fc_op.prepared(w)
    key = (id(w), "weight")
    assert key in fc_op._CACHE
    del w
    assert key not in fc_op._CACHE


# ---------------------------------------------------------------------------
# The wrapper's arguments and the rows the kernel reads
# ---------------------------------------------------------------------------

def test_padded_and_aligned_rows():
    for dtype, cols, ld in ((torch.float32, 1006, 1008),
                            (torch.float32, 500, 500),
                            (torch.bfloat16, 100, 104),
                            (torch.float32, 10, 12)):
        v = fc_op.padded_rows(7, cols, dtype, "cpu")
        assert v.shape == (7, cols) and v.stride() == (ld, 1)
        assert fc_op.rows_aligned(v)
    x = torch.randn(5, 1006)
    assert not fc_op.rows_aligned(x)
    y = fc_op.aligned_rows(x)
    assert y.stride() == (1008, 1) and torch.equal(y, x)
    z = torch.randn(5, 1008)
    assert fc_op.aligned_rows(z) is z


def test_wrapper_checks_its_arguments_and_writes_out():
    g = torch.Generator().manual_seed(9)
    x, w = torch.randn((6, 8), generator=g), torch.randn((8, 5), generator=g)
    with pytest.raises(ValueError, match="are not"):
        fc_op.augment_fc(x, w[:7])
    affine = {"mean": torch.zeros(5), "var": torch.ones(5),
              "scale": torch.ones(5), "bias": torch.zeros(5)}
    with pytest.raises(ValueError, match="affine"):
        fc_op.augment_fc(x, w, stats=affine)
    with pytest.raises(ValueError, match="mask"):
        fc_op.augment_fc(x, w, mask=torch.ones((3, 4)))
    with pytest.raises(ValueError, match="unsupported device"):
        fc_op.augment_fc(x.to("meta"), w.to("meta"))
    before = fc_op.augment_fc.launches
    got = fc_op.augment_fc(x, w)
    assert fc_op.augment_fc.launches == before
    assert torch.equal(got, fc_op.augment_fc_reference(x, w))


# ---------------------------------------------------------------------------
# augment_arms: the CPU path as it was, the CUDA path's plumbing
# ---------------------------------------------------------------------------

def _model(variant, n_zim, dtype=torch.float32):
    cfg = aug.AugmenterConfig(**SMALL, variant=variant, n_zim=n_zim)
    g = torch.Generator().manual_seed(11)
    params, bn = aug.init_augmenter(g, cfg)
    for stats in bn.values():
        stats["mean"] = torch.randn(stats["mean"].shape, generator=g) / 10
        stats["var"] = 0.5 + torch.rand(stats["var"].shape, generator=g)
    x = (torch.relu(torch.randn((33, SMALL["input_dim"]), generator=g))
         * (torch.rand((33, SMALL["input_dim"]), generator=g) > 0.3))
    if dtype != torch.float32:
        params = aug.cast_augmenter_params(params, dtype)
        x = x.to(dtype)
    return cfg, params, bn, x


def _draws(cfg, A, B):
    g = torch.Generator().manual_seed(12)
    return aug.AugNoise(z=torch.randn((A, B, cfg.noise_dim), generator=g),
                        e=torch.randn((A, B, cfg.latent_dim), generator=g))


def _augment_arms_as_it_was(params, bn, cfg, x, n_arm, scale, draws):
    """augment_arms' plain path, step by step as the module had it before
    its layers went through ``_plain_layer``."""
    lin = aug._lin

    def ev(name, h, act=torch.relu):
        eps, mom = aug._BN_HYPERS.get(name, (aug.BN_EPS, aug.BN_MOMENTUM))
        y, _ = aug._bn(h, bn[name], False, eps, mom)
        return act(y) if act else y
    h = x
    for fc, norm in (("fc1", "bn1"), ("fc2", "bn2"), ("fc3", "bn3"),
                     ("fc4", "bn4")):
        h = ev(norm, lin(params[fc], h))
    h = h.expand(n_arm, *h.shape)
    z = scale * draws.z.to(h.dtype)
    z = ev("bnz", lin(params["noise"], z), act=torch.nn.functional.elu)
    h = ev("bn5", lin(params["fc5"], torch.cat([h, z], dim=-1)))
    mu = ev("bn_mu", lin(params["fc_mu"], h), act=None)
    sigma = torch.sigmoid(lin(params["fc_sigma"], h))
    h = ev("bn6", lin(params["fc6"], mu + draws.e.to(mu.dtype) * sigma))
    for fc, norm in (("fc7", "bn7"), ("fc8", "bn8"), ("fc9", "bn9"),
                     ("fc10", "bn10")):
        h = ev(norm, lin(params[fc], h))
    x_mu = (h @ params["fc11"]["w"]).add_(params["fc11"]["b"]).relu_()
    if cfg.n_zim > 1:
        x_mu.mul_((x > 0).to(x_mu.dtype))
    return x_mu


VARIANTS = [("smartseq", 1), ("smartseq", 2), ("generic", 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant,n_zim", VARIANTS)
def test_augment_arms_on_the_cpu_is_the_plain_path(variant, n_zim, dtype):
    cfg, params, bn, x = _model(variant, n_zim, dtype)
    draws = _draws(cfg, 3, x.shape[0])
    before = fc_op.augment_fc.launches
    got = aug.augment_arms(params, bn, cfg, x, 3, 0.1, draws=draws)
    want = _augment_arms_as_it_was(params, bn, cfg, x, 3, 0.1, draws)
    assert torch.equal(got, want)
    assert fc_op.augment_fc.launches == before


def _as_on_the_card(monkeypatch):
    """augment_arms takes its CUDA path (``_fused_layer``) on CPU tensors,
    where augment_fc runs its plain version; returns the weights of every
    call of augment_fc, in order."""
    seen = []
    fused = fc_op.augment_fc

    def counted(x, w, *a, **k):
        seen.append(w)
        return fused(x, w, *a, **k)
    monkeypatch.setattr(aug, "on_cpu", lambda *t: False)
    monkeypatch.setattr(fc_op, "augment_fc", counted)
    return seen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant,n_zim", VARIANTS)
def test_fused_path_follows_the_plain_path(variant, n_zim, dtype,
                                           monkeypatch):
    """The CUDA path (every layer of FUSED_LAYERS through augment_fc, in
    that order, once each; rows made 16-byte aligned; fc11 with the mask)
    run on the CPU through the kernel's plain version: f32 within the
    3xTF32 products' rounding, bf16 bit for bit; the draws from a
    generator in the same order."""
    cfg, params, bn, x = _model(variant, n_zim, dtype)
    A, B = 3, x.shape[0]
    draws = _draws(cfg, A, B)
    want = aug.augment_arms(params, bn, cfg, x, A, 0.1, draws=draws)
    gen = [torch.Generator().manual_seed(13) for _ in range(2)]
    want_g = aug.augment_arms(params, bn, cfg, x, A, 0.1, gen[0])
    seen = _as_on_the_card(monkeypatch)
    got = aug.augment_arms(params, bn, cfg, x, A, 0.1, draws=draws)
    assert [id(w) for w in seen] == [id(params[fc]["w"])
                                     for fc, _ in aug.FUSED_LAYERS]
    assert got.shape == (A, B, cfg.input_dim) and got.dtype == dtype
    assert got.is_contiguous()
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    else:
        assert torch.equal(got, want)
    if n_zim > 1:
        assert bool((got[:, x == 0] == 0).all())
    got = aug.augment_arms(params, bn, cfg, x, A, 0.1, gen[1])
    tol = 1e-6 if dtype == torch.float32 else 0.0
    assert (got.float() - want_g.float()).abs().max() <= tol * want_g.abs().max()
    assert torch.equal(gen[0].get_state(), gen[1].get_state())


def test_plain_layer_keeps_the_gradients(monkeypatch):
    """``_plain_layer`` writes the bias, the ReLU and the mask where the
    product was written; under autograd (``apply_augmenter`` in the GAN
    trainer) the gradients are those of the out-of-place layer."""
    g = torch.Generator().manual_seed(14)
    x = torch.randn((2, 9, 12), generator=g)
    w = torch.randn((12, 7), generator=g, requires_grad=True)
    b = torch.randn((7,), generator=g, requires_grad=True)
    stats = _stats(g, 7)
    mask = torch.relu(torch.randn((9, 7), generator=g))
    bn = {"bn1": stats}

    def ev(name, h, act=torch.relu):
        return act(aug._bn(h, bn[name], True)[0])
    layer = aug._plain_layer({"fc1": {"w": w, "b": b}}, ev)
    for norm, m in (("bn1", None), (None, mask)):
        y = layer("fc1", norm, x, m)
        got = torch.autograd.grad((y * y).sum(), (w, b))
        want_y = aug._lin({"w": w, "b": b}, x)
        want_y = ev(norm, want_y) if norm else torch.relu(want_y)
        if m is not None:
            want_y = want_y * (m > 0)
        want = torch.autograd.grad((want_y * want_y).sum(), (w, b))
        assert torch.equal(y, want_y)
        assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_the_closure_prepares_every_fused_layer(monkeypatch):
    """``make_augment_apply`` on the card lays out the weight of every
    layer of FUSED_LAYERS when it is made, and no other."""
    cfg, params, bn, x = _model("smartseq", 1)
    monkeypatch.setattr(aug, "on_cpu", lambda *t: False)
    aug.make_augment_apply(params, bn, cfg)
    ids = {k[0] for k in fc_op._CACHE if k[1] == "weight"}
    want = {id(params[fc]["w"]) for fc, _ in aug.FUSED_LAYERS}
    assert want <= ids
    assert not ids & {id(p["w"]) for name, p in params.items()
                      if name not in dict(aug.FUSED_LAYERS)}
