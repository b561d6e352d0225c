"""The frozen work counts against hand arithmetic, and the roofline bounds
against the kernels' bounds of PERF.md §6."""

import pytest

from portbench.core import roofline, spec, work

MSE = spec.config("mmidas-ss-a5-mse")["model"]
ZINB = spec.config("mmidas-ss-a5-zinb")["model"]


def test_mse_step_flops_by_hand():
    # per arm and row: fc1 5032·100, fc2-4 3·100², fc5 100·10, fcc 10·92,
    # fc_mu and fc_sigma 2·102·2, fc6 94·10, fc7 10·100, fc8-10 3·100²,
    # fc11 100·5032
    s = (5032 * 100 + 3 * 100 * 100 + 100 * 10 + 10 * 92 + 2 * 102 * 2
         + 94 * 10 + 10 * 100 + 3 * 100 * 100 + 100 * 5032)
    assert s == 1_070_668
    per_row = 2 * 5 * (3 * s - 5032 * 100)
    assert work.train_step_flops(MSE, 5000) == pytest.approx(per_row * 5000,
                                                             rel=1e-12)
    assert work.train_step_flops(MSE, 5000) == pytest.approx(1.356e11,
                                                             rel=2e-3)


def test_zinb_step_flops_by_hand():
    s = 1_070_668 + 2 * 100 * 5032
    per_row = 2 * 5 * (3 * s - 5032 * 100)
    assert work.train_step_flops(ZINB, 5000) == pytest.approx(per_row * 5000,
                                                              rel=1e-12)
    assert work.train_step_flops(ZINB, 5000) == pytest.approx(2.86e11,
                                                              rel=2e-3)


def test_eval_flops_by_hand():
    assert work.eval_flops(MSE, 1) == 2 * 5 * 1_070_668
    assert work.eval_flops(ZINB, 10) == 10 * 2 * 5 * (1_070_668 + 1_006_400)


@pytest.mark.parametrize("fn,model,bound_ms", [
    (work.encoder_fc1, MSE, 2 * 0.0508),
    (work.recon_train, MSE, 0.1525),
    (work.zinb_train, ZINB, 0.4575),
    (work.recon_serve, MSE, 0.0508),
    (work.zinb_serve, ZINB, 0.1525),
])
def test_bounds_of_a_full_batch(fn, model, bound_ms):
    calls = fn(model, 5000, 4)
    assert 1e3 * roofline.bound_s(calls, "float32") == pytest.approx(
        bound_ms, rel=2e-3)
    # operations bound every one of these kernels, not bytes
    for f, b in calls:
        peak = roofline.PEAK_FLOPS["float32"]
        assert f / peak > b / roofline.HBM_BYTES_PER_S


def test_share_is_none_without_a_reading():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(0.0, 1.0) is None
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.mfu_pct(0.0, 1.0, "float32") is None
