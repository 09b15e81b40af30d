"""The benchmark's operation counts against the bounds PERF.md keeps and a
count by hand."""

import pytest

from portbench import counts

CBC = dict(conditioning="Cond-by-Concat", hidden_layers=5, hidden_features=256,
           equivariance="SO2", out_features=3, latent_dim=49)
FILM = dict(CBC, conditioning="FiLM")


@pytest.mark.parametrize("model, ms", [(CBC, 1.6357), (FILM, 1.3100)])
def test_step_bound_at_the_flagship_batch(model, ms):
    """100 maps x 8,192 directions at 989 TFLOP/s (``chip_smoke.py``)."""
    step = counts.fit_decoder_step(model, 100, 8192)
    assert round(step["flops"] / counts.PEAK_BF16_FLOPS * 1e3, 4) == ms
    assert step["least_s"] == step["flops"] / counts.PEAK_BF16_FLOPS  # bound by operations


def test_pow_by_squaring_multiplies():
    # 500 = 0b111110100: 8 squarings, 5 products of set bits
    assert counts.pow_multiplies(500) == 13
    assert counts.pow_multiplies(1) == 0
    assert counts.pow_multiplies(2) == 1


def test_shading_count_by_hand():
    """Two covered pixels, three lights, one map: a (pixel, light) pays N.L
    5, its clamp 2, V.L 5, the inverse norm 5, N.H 4, the power 13, the two
    light sums 12 and their backward 12."""
    assert counts.shading_flops(2, 3, 1) == 2 * 3 * (5 + 2 + 5 + 5 + 4 + 13 + 12 + 12)


def test_inverse_step_takes_each_part_at_its_peak():
    step = counts.fit_inverse_step(CBC, 3, 8192, 5000)
    dec = 3 * 8192 * counts.step_flops_per_pixel(CBC, weight_grads=False)
    assert step["decoder_flops"] == dec
    assert step["least_s"] == pytest.approx(dec / 989e12 + step["shading_flops"] / 67e12)
