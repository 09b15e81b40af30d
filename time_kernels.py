#!/usr/bin/env python3
"""Time the port's training kernels on the card, for comparing two variants
of a kernel source in one process chain on one card.

    python3 time_kernels.py             # from the repository root, one NVIDIA GPU
    python3 time_kernels.py --anatomy   # the anatomy probes in place of the kernels

Builds the kernels, then at full width (the Cond-by-Concat and FiLM Zoo
decoders, bf16 trunk, fast sine) prints the median time of both train-step
kernels at 100 x 8,192 and 21 x 8,192 (at 100 x 8,192 also each of their
layer-major passes alone, with bytes, FLOPs and achieved rates, and the
torch.matmul yardstick of chip_smoke.pass_timings), of both backward kernels at 21 x
32,768 and 21 x 8,192 with and without weight gradients (the bf16 trunk on the
layer-major passes), each after one check against its plain version
(max |difference| / max |plain| per result); then both forward kernels (the
fused kernel and the row-tile kernel's instantiation for the same trunk) of
both decoders at 21 x 32,768 and 21 x 8,192, and L2's read rate
(``chip_smoke.l2_read_rate``). Two cards, or one card at two moments,
differ by up to 12% on the same code: to compare two versions of a source,
run this script once per version inside one command, in turns (old, new,
new, old); the build directory is keyed by a hash of the sources, so each
version builds anew.

With ``--anatomy`` (the counterpart of ``benchmarks/bwd_anatomy.py``) it
prints instead, at 21 x 8,192 and at 21 x 32,768 on the Cond-by-Concat Zoo
decoder, the median time of the shipped forward and backward kernels and of
each probe of ``reni_tpu_torch/kernels/anatomy.py`` (``fwd``, ``fwd_no_sine``,
``fwd_interleave2``, ``fwd_interleave4`` (the bf16 forward's probes are the
fused kernel without sines and in lock step, and the row-tile kernel's
sub-tiles), ``bwd``, ``bwd_no_accum``, ``bwd_no_sincos``, ``bwd_no_dw``,
``bwd_mxu_only`` (the bf16 backward's probes are the layer-major passes:
the shipped ones, the passes built with the linear stand-in, and the passes
without the reduction after them)), and of the weight-gradient product
``wgrad_bf16`` alone, without and with the sum of its split-K partials; then
the attribution line of the shipped backward at each shape
(``chip_smoke.attribution``: sines, weight work, the reduction after the
passes, ``wgrad_bf16``, the skeleton, against the bound and the passes' byte
floor): what each part of the shipped kernels costs.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

import chip_smoke as cs


def relative_errors(got, ref) -> str:
    return " ".join(
        f"{((x - y).abs().max() / y.abs().max()).item():.2g}"
        for x, y in zip(got, ref) if y is not None and y.numel()
    )


ANATOMY_SHAPES = ((21, 128), (21, 256))  # (latents, width): 21 x 8,192 and 21 x 32,768


def anatomy(dev) -> None:
    """Print the probes' times at ANATOMY_SHAPES, then the card line."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.train import checkpoint as ckpt

    cfg, dec, _ = cs.load_entry(cs.CBC, dev)
    table = ckpt.load_checkpoint(os.path.join(cs.CBC, "checkpoint"))[0]["latents"]["mu"]
    mu = torch.as_tensor(table, device=dev)
    with torch.no_grad():
        for batch, width in ANATOMY_SHAPES:
            D = sphere.get_directions(width, device=dev)
            times = cs.time_anatomy(cfg, dec, mu[:batch], D, runs=15)
            for name, ms in times.items():
                if isinstance(ms, float):
                    print(f"{name} {batch} x {D.shape[1]:,}: {ms:.3f} ms")
            torch.cuda.empty_cache()
    print(cs.card_line())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--anatomy", action="store_true",
                    help="time the anatomy probes in place of the training kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.anatomy:
        cs.build_all()
        anatomy(torch.device(cs.DEVICE))
        return 0
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_step as ts
    from reni_tpu_torch.train import checkpoint as ckpt

    dev = torch.device(cs.DEVICE)
    cs.build_all()
    cfg, dec, z21 = cs.load_entry(cs.CBC, dev)
    table = ckpt.load_checkpoint(os.path.join(cs.CBC, "checkpoint"))[0]["latents"]["mu"]
    mu = torch.as_tensor(table, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step_case(batch: int, width: int):
        D = sphere.get_directions(width, device=dev)
        targets = torch.tanh(torch.randn((batch, D.shape[1], 3), generator=gen, device=dev))
        ops = cs.step_operands(cfg, dec, mu[:batch], D, targets,
                               sphere.get_sineweight(width, device=dev))
        return ops, cs.step_kwargs(cfg, D.shape[1])

    with torch.no_grad():
        ops, kw = step_case(100, 64)
        got, ref = ts.siren_step_cuda(*ops, **kw), ts.siren_step_reference(*ops, **kw)
        torch.cuda.synchronize()
        print(f"siren_step 100 x 2,048 vs plain: {relative_errors(got, ref)}")
        for batch in (100, 21):
            ops, kw = step_case(batch, 128)
            ms = cs.time_ms(lambda: ts.siren_step_cuda(*ops, **kw), runs=15)
            print(f"siren_step {batch} x 8,192: {ms:.3f} ms")
            if batch == 100:
                cs.pass_timings("siren_step", cfg, ops, kw, dev)
        del ops
        cfg_f, dec_f, _ = cs.load_entry(cs.FILM, dev)
        for batch, width in ((100, 64), (100, 128), (21, 128)):
            D = sphere.get_directions(width, device=dev)
            targets = torch.tanh(torch.randn((batch, D.shape[1], 3), generator=gen, device=dev))
            fops = cs.step_operands(cfg_f, dec_f, mu[:batch], D, targets,
                                    sphere.get_sineweight(width, device=dev))
            fkw = cs.step_kwargs(cfg_f, D.shape[1])
            if width == 64:
                got, ref = ts.film_step_cuda(*fops, **fkw), ts.film_step_reference(*fops, **fkw)
                torch.cuda.synchronize()
                print(f"film_step 100 x 2,048 vs plain: {relative_errors(got, ref)}")
            else:
                ms = cs.time_ms(lambda: ts.film_step_cuda(*fops, **fkw), runs=15)
                print(f"film_step {batch} x 8,192: {ms:.3f} ms")
                if batch == 100:
                    cs.pass_timings("film_step", cfg_f, fops, fkw, dev)
        del fops
        for width in (256, 128):
            D = sphere.get_directions(width, device=dev)
            g = cs.cotangent(z21, D.shape[1], seed=3)
            for name, entry in (("siren_bwd", cs.CBC), ("film_bwd", cs.FILM)):
                cfg_e, dec_e, z = cs.load_entry(entry, dev)
                trunk_ops = cs.packed(cfg_e, dec_e, z, D)
                for wgrad in (False, True):
                    kernel, plain, bkw = cs.bwd_fns(cfg_e, weight_grads=wgrad)
                    errs = relative_errors(kernel(*trunk_ops, g, **bkw),
                                           plain(*trunk_ops, g, **bkw))
                    ms = cs.time_ms(lambda: kernel(*trunk_ops, g, **bkw), runs=10)
                    print(f"{name} 21 x {D.shape[1]:,} {'with' if wgrad else 'without'} weight "
                          f"gradients: {ms:.3f} ms; vs plain {errs}")
        for name, entry in (("siren_fwd", cs.CBC), ("film_fwd", cs.FILM)):
            cfg_e, dec_e, z = cs.load_entry(entry, dev)
            kernel, plain, fkw = cs.trunk_fns(cfg_e)
            for width in (256, 128):
                D = sphere.get_directions(width, device=dev)
                trunk_ops = cs.packed(cfg_e, dec_e, z, D)
                errs = relative_errors([kernel(*trunk_ops, **fkw)], [plain(*trunk_ops, **fkw)])
                ms = {route: cs.time_ms(lambda: kernel(*trunk_ops, route=route, **fkw), runs=15)
                      for route in ("fused", "tile")}
                print(f"{name} 21 x {D.shape[1]:,}: fused kernel {ms['fused']:.3f} ms, row-tile "
                      f"kernel {ms['tile']:.3f} ms; vs plain {errs}")
    cs.l2_read_rate(dev)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
