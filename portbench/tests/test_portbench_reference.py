"""The reference against the port's plain path on the CPU at tiny sizes, in
float64: the decoders, FIT_DECODER's steps with Adam (Cond-by-Concat and
FiLM), the shading."""

import copy

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import fit_decoder as ref_fit
from portbench.reference import reni, scene as scene_lib

TINY = dict(latent_dim=5, hidden_layers=2, hidden_features=16, mapping_layers=2,
            mapping_features=16)


def _model(conditioning):
    conf = harness.load_json(harness.HERE / "configs" / "reni_cbc_5x256.json")["model"]
    return dict(conf, conditioning=conditioning, **TINY, use_pallas=False, fast_sine=False)


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f64(v) for v in tree]
    return tree.double()


@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
def test_decode_matches_the_plain_decoder(conditioning):
    from reni_tpu_torch.models.reni import RENIConfig, RENIModel

    model = _model(conditioning)
    gen = weights.generator(2**40 + 3, "cpu")
    dec = _f64(weights.decoder(model, gen, "cpu"))
    Z = torch.randn((3, model["latent_dim"], 3), generator=gen, dtype=torch.float64)
    D = reni.directions(16, "cpu").double()
    port = RENIModel(RENIConfig(**model)).apply({"decoder": dec}, Z, D)
    ours = reni.decode(model, dec, Z, D)
    torch.testing.assert_close(ours, port, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
def test_fit_decoder_steps_match_the_port(conditioning):
    """Three steps of the port's ``make_fit_decoder_step`` through
    ``run_stage`` (plain decoder, float64) against ``ref_fit.follow``."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.models.reni import RENIConfig, RENIModel
    from reni_tpu_torch.train import tasks
    from reni_tpu_torch.train.optim import OptimConfig

    model = _model(conditioning)
    task = dict(lr_start=1e-3, lr_end=1e-5, beta1=0.0, beta2=0.9, epochs=10, kld_weighting=1e-2)
    gen = weights.generator(7, "cpu")
    params = _f64({"decoder": weights.decoder(model, gen, "cpu"),
                   "latents": weights.latents(model, gen, 12, "cpu")})
    maps = weights.maps(gen, 12, 8 * 16, -0.9, 0.9, "cpu").double()
    port_model = RENIModel(RENIConfig(**model))
    optim = OptimConfig(lr_start=1e-3, lr_end=1e-5, beta1=0.0, beta2=0.9, epochs=10,
                        steps_per_epoch=3)
    state = tasks.init_train_state(port_model, copy.deepcopy(params), optim,
                                   torch.Generator().manual_seed(5))
    D = sphere.get_directions(16, device="cpu")
    sw = sphere.get_sineweight(16, device="cpu").double()
    step = tasks.make_fit_decoder_step(port_model, D, sw, kld_weighting=1e-2)
    state, metrics = tasks.run_stage(step, state, maps, 1, 4)
    ref = ref_fit.follow(model, task, params, maps, torch.Generator().manual_seed(5),
                         steps=3, batch=4, steps_per_epoch=3, width=16, block=3)
    assert np.mean(ref["losses"]) == pytest.approx(float(metrics["loss"][0]), rel=1e-8)
    after = reni.flatten(state.params)
    # Adam divides by |g| + 1e-8: where an element of the gradient is near
    # 1e-8, its last bits reach the update; 1e-9 is a millionth of a step
    for k, change in ref["change"].items():
        torch.testing.assert_close(after[k] - reni.flatten(params)[k], change,
                                   rtol=1e-5, atol=1e-9)


def test_shading_matches_the_port():
    """The explicit half vector of the reference against the port's shading
    (numpy fragments), float64, on the committed teapot at 24 x 24."""
    from reni_tpu_torch.render import mesh as mesh_lib
    from reni_tpu_torch.render import shading
    from reni_tpu_torch.render.rasterizer import rasterize_world

    obj = str(harness.ROOT / "data" / "3D_Models" / "teapot.obj")
    m = mesh_lib.load_obj(obj)
    frags, eye = rasterize_world(m, 24, backend="numpy")
    render = shading.make_render_fn(frags, m.face_verts, mesh_lib.vertex_normals(m)[m.faces],
                                    eye, kd=0.5, device="cpu")
    gen = torch.Generator().manual_seed(3)
    env = torch.rand((2, 8 * 16, 3), generator=gen, dtype=torch.float64) * 3.0
    sw = reni.sineweight(16, "cpu").double()
    D = reni.directions(16, "cpu")
    port = render(env, sw.expand(env.shape), D[0])
    scene = scene_lib.Scene(obj, 24, "cpu")
    ours = scene_lib.shade(scene, D[0].double(), env * sw, kd=0.5)
    assert scene.covered == int((frags.pix_to_face >= 0).sum())
    # both sides' geometry is float32 (the port's interpolated in float32,
    # ours in float64 then rounded): the power 500 turns their 1e-7 into 5e-5
    torch.testing.assert_close(ours, port, rtol=1e-4, atol=1e-4 * float(port.abs().max()))
