"""The benchmark's inputs from ``--seed``: a fresh decoder, a latent table
and environment maps, made on the device by one ``torch.Generator`` in a few
large calls, in float32, the dtype they are trained in.

The decoder follows the published initialisation in distribution (SIREN:
the first layer U(+-scale / in), the others U(+-sqrt(6 / H) / omega),
biases U(+-1 / sqrt(in)); FiLM: the trunk's hidden and final layers
U(+-sqrt(6 / H) / 25), the mapping network kaiming-normal with the last
weight scaled by 0.25). The numbers are the benchmark's own: the program
and the reference are handed the same tensors, or make them again here from
the same seed. Plain torch: nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch

def concat_in(n: int) -> int:
    """Width of the SO2 Cond-by-Concat encoding: innerprod (N), Gram (N^2),
    |D_xz| (1), Z_y (N), D_y (1)."""
    return 2 * n + n * n + 2


def _tree(model: dict, take) -> dict:
    """The decoder tree, each leaf ``take(kind, shape, scale)`` in a fixed
    order; kind "u" draws U(-scale, scale), "n" draws N(0, scale^2)."""
    if model["equivariance"] != "SO2":
        raise ValueError("the benchmark's configurations are SO2")
    H, N, n_out = model["hidden_features"], model["latent_dim"], model["out_features"]
    scale = model.get("first_layer_init_scale", 1.0)

    def linear(fan_in, fan_out, w_bound):
        return {"w": take("u", (fan_in, fan_out), w_bound),
                "b": take("u", (fan_out,), 1.0 / math.sqrt(fan_in))}

    if model["conditioning"] != "FiLM":
        c_in, hidden = concat_in(N), math.sqrt(6.0 / H) / model["hidden_omega_0"]
        layers = [linear(c_in, H, scale / c_in)]
        layers += [linear(H, H, hidden) for _ in range(model["hidden_layers"])]
        return {"layers": layers, "final": linear(H, n_out, hidden)}
    n_trunk, bound = model["hidden_layers"], math.sqrt(6.0 / H) / 25.0
    layers = [linear(2 + N, H, scale / (2 + N))]
    layers += [linear(H, H, bound) for _ in range(1, n_trunk)]
    final = linear(H, n_out, bound)
    gain, M, fan_in = math.sqrt(2.0 / (1.0 + 0.2**2)), model["mapping_features"], N * N + N
    mapping = []
    for _ in range(model["mapping_layers"]):
        mapping.append({"w": take("n", (fan_in, M), gain / math.sqrt(fan_in)),
                        "b": take("u", (M,), 1.0 / math.sqrt(fan_in))})
        fan_in = M
    last = {"w": take("n", (fan_in, 2 * n_trunk * H), 0.25 * gain / math.sqrt(fan_in)),
            "b": take("u", (2 * n_trunk * H,), 1.0 / math.sqrt(fan_in))}
    return {"layers": layers, "final": final, "mapping": {"layers": mapping, "last": last}}


def decoder(model: dict, gen: torch.Generator, device) -> dict:
    """A fresh decoder tree ``{"layers": [{"w", "b"}, ...], "final": ...[,
    "mapping": ...]}``, weights (in, out): one uniform and one normal draw."""
    sizes = {"u": 0, "n": 0}

    def count(kind, shape, scale):
        sizes[kind] += math.prod(shape)

    _tree(model, count)
    pools = {"u": torch.rand(sizes["u"], generator=gen, device=device) * 2.0 - 1.0,
             "n": torch.randn(sizes["n"], generator=gen, device=device) if sizes["n"] else None}
    offset = {"u": 0, "n": 0}

    def take(kind, shape, scale):
        n, o = math.prod(shape), offset[kind]
        offset[kind] = o + n
        return pools[kind][o: o + n].reshape(shape) * scale

    return _tree(model, take)


def latents(model: dict, gen: torch.Generator, rows: int, device) -> dict:
    """A VAD latent table: mu ~ N(0, 1), log_var ~ N(-5, 1), one draw."""
    r = torch.randn((2, rows, model["latent_dim"], 3), generator=gen, device=device)
    return {"mu": r[0].clone(), "log_var": r[1] - 5.0}


def maps(gen: torch.Generator, count: int, pixels: int, lo: float, hi: float, device):
    """``count`` environment maps of ``pixels`` RGB values, uniform in the
    normalised range [lo, hi): the step's time does not depend on them."""
    return torch.rand((count, pixels, 3), generator=gen, device=device) * (hi - lo) + lo


def generator(seed: int, device) -> torch.Generator:
    """The generator of the inputs on ``device``; ``seed`` may pass 32 bits."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
