#!/usr/bin/env python3
"""Time the port's training kernels on the card, for comparing two variants
of a kernel source in one process chain on one card.

    python3 time_kernels.py             # from the repository root, one NVIDIA GPU
    python3 time_kernels.py --anatomy   # the anatomy probes in place of the kernels
    python3 time_kernels.py --float32   # the Zoo's trunks under the float32 trunk
    python3 time_kernels.py --tiled     # the tiled passes at the widths they take

Builds the kernels, then at full width (the Cond-by-Concat and FiLM Zoo
decoders, bf16 trunk, fast sine) prints the median time of both train-step
kernels at 100 x 8,192 and 21 x 8,192 (at 100 x 8,192 also each of their
layer-major passes alone, with bytes, FLOPs and achieved rates, and dWs =
h^T dz alone over the step's scratch beside torch.bmm of the same scratch,
a yardstick the port never calls: chip_smoke.pass_timings, and ``dws_split``
in entry points an older tree has), of both backward kernels at 21 x
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
``wgrad_bf16`` (the wgmma split-K GEMM over tensor-map K-slabs of the
scratch) alone, without and with the sum of its split-K partials; then
the attribution line of the shipped backward at each shape
(``chip_smoke.attribution``: sines, weight work, the reduction after the
passes, ``wgrad_bf16``, the skeleton, against the bound and the passes' byte
floor): what each part of the shipped kernels costs.

With ``--float32`` it prints instead the median time of both train-step
kernels at 100 x 8,192 and of both backward kernels at 21 x 8,192 with and
without weight gradients, on the Cond-by-Concat and FiLM Zoo decoders (5 x
256) run with the float32 trunk (``TPU.PRECISION: float32``), each after one
check against its plain version, and whether the trunk is on the
layer-major passes (``siren_step.pass_route``). It uses only entry points
that the port has had since its chain kernels took the float32 trunk, so
the same file times an older tree: copy it into that tree's root and run it
there.

With ``--tiled`` it prints instead the median time of the tiled passes'
routes at TILED_SHAPES (the step at FIT_DECODER's 100 x 8,192 and the
backward without weight gradients at FIT_LATENT's 21 x 8,192, on
``chip_smoke.wide_operands``' trunks), each after one check against its
plain version, the step's dWs alone over its scratch beside torch.bmm
(``dws_split``), and the plain step's time at float32 5 x 512. It too uses
entry points an older tree has (since the tiled passes came in), so the same
file times that tree when copied into its root.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

import chip_smoke as cs


def step_scratch(film: bool, args, kw, dev):
    """(plan, work) after one step's passes: the scratch sc_h / sc_dz that
    dWs reads. Uses only entry points that a tree has had since its tiled
    passes came in."""
    from reni_tpu_torch.kernels import siren_step as ts

    plan = ts.step_plan_cuda(film, args, dev, trunk=kw["trunk"])
    work = ts.PassWork.for_plan(plan, plan.trunk, dev)
    ts._pass_call(plan, ts.pass_operands(plan, args, kw), work, 0, len(plan.passes),
                  ts.FINISH_IMG | ts.FINISH_W)
    return plan, work


def dws_split(film: bool, args, kw, dev) -> str:
    """dWs = h^T dz alone over the scratch of one step's passes: the kernel
    alone and with the sum of its split-K partials, beside torch.bmm of the
    same scratch (a yardstick the port never calls)."""
    from reni_tpu_torch.kernels import anatomy as ta

    plan, work = step_scratch(film, args, kw, dev)
    h, dz = work.sc_h, work.sc_dz
    alone = cs.time_ms(lambda: ta.weight_grads_cuda(h, dz, reduce=False), runs=10)
    summed = cs.time_ms(lambda: ta.weight_grads_cuda(h, dz), runs=10)
    bmm = cs.time_ms(lambda: torch.bmm(h.transpose(1, 2), dz), runs=10)
    del work
    return (f"dWs {' x '.join(f'{n:,}' for n in h.shape)} {plan.trunk}: alone {alone:.4f} ms, "
            f"with its split-K sum {summed:.4f} ms; torch.bmm of the same scratch {bmm:.4f} ms")


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


def float32_zoo(dev) -> None:
    """Print the float32 trunk's step and backward times on the Zoo's 5 x
    256 decoders (``--float32``), then the card line."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_step as ts
    from reni_tpu_torch.train import checkpoint as ckpt

    table = ckpt.load_checkpoint(os.path.join(cs.CBC, "checkpoint"))[0]["latents"]["mu"]
    mu = torch.as_tensor(table, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    D = sphere.get_directions(128, device=dev)
    P = D.shape[1]
    with torch.no_grad():
        for name, entry in (("siren", cs.CBC), ("film", cs.FILM)):
            cfg, dec, z21 = cs.load_entry(entry, dev)
            n_mm = cfg.hidden_layers - 1 if cfg.is_film else cfg.hidden_layers
            print(f"{name} float32 {cfg.hidden_layers} x {cfg.hidden_features}: on the passes "
                  f"{ts.pass_route('float32', cfg.hidden_features, n_mm)}")
            targets = torch.tanh(torch.randn((100, P, 3), generator=gen, device=dev))
            ops = cs.step_operands(cfg, dec, mu[:100], D, targets,
                                   sphere.get_sineweight(128, device=dev))
            kw = cs.step_kwargs(cfg, P, "float32")
            kernel = ts.film_step_cuda if cfg.is_film else ts.siren_step_cuda
            plain = ts.film_step_reference if cfg.is_film else ts.siren_step_reference
            errs = relative_errors(kernel(*ops, **kw)[1:], plain(*ops, **kw)[1:])
            ms = cs.time_ms(lambda: kernel(*ops, **kw), runs=10)
            print(f"{name}_step float32 100 x {P:,}: {ms:.3f} ms; vs plain {errs}")
            del ops
            trunk_ops, g = cs.packed(cfg, dec, z21, D), cs.cotangent(z21, P, seed=3)
            for wgrad in (False, True):
                bwd, plain_bwd, bkw = cs.bwd_fns(cfg, trunk="float32", weight_grads=wgrad)
                errs = relative_errors(bwd(*trunk_ops, g, **bkw), plain_bwd(*trunk_ops, g, **bkw))
                ms = cs.time_ms(lambda: bwd(*trunk_ops, g, **bkw), runs=10)
                print(f"{name}_bwd float32 21 x {P:,} {'with' if wgrad else 'without'} weight "
                      f"gradients: {ms:.3f} ms; vs plain {errs}")
            torch.cuda.empty_cache()
    print(cs.card_line())


# (name, trunk, H, H x H products, batch): the step at 100 x 8,192, the
# backward without weight gradients at 21 x 8,192
TILED_SHAPES = (("siren_step", "bfloat16", 512, 5, 100), ("film_step", "bfloat16", 512, 4, 100),
                ("siren_bwd", "bfloat16", 512, 5, 21), ("siren_step", "float32", 256, 5, 100),
                ("siren_step", "float32", 512, 5, 100), ("siren_bwd", "float32", 512, 5, 21))


def tiled(dev) -> None:
    """Print the tiled routes' times at TILED_SHAPES (``--tiled``), then the
    card line."""
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_step as ts

    with torch.no_grad():
        for name, trunk, H, n_mm, B in TILED_SHAPES:
            film = name.startswith("film")
            ops, g, loss_ops = cs.wide_operands(film, H, n_mm, dev, B=B, seed=31)
            P = g.shape[1]
            kw = cs.wide_kw(film, trunk)
            if name.endswith("step"):
                kernel = ts.film_step_cuda if film else ts.siren_step_cuda
                plain = ts.film_step_reference if film else ts.siren_step_reference
                args, fkw = (*ops, *loss_ops), dict(kw, out_act="tanh", gscale=1.0 / (3 * P))
            else:
                kernel = tb.film_trunk_bwd_cuda if film else tb.siren_trunk_bwd_cuda
                plain = tb.film_trunk_bwd_reference if film else tb.siren_trunk_bwd_reference
                args, fkw = (*ops, g), dict(kw, weight_grads=False)
            errs = relative_errors(kernel(*args, **fkw), plain(*args, **fkw))
            ms = cs.time_ms(lambda: kernel(*args, **fkw), runs=5, warmup=1)
            line = f"tiled {name} {trunk} {n_mm} x {H} {B} x {P:,}: {ms:.3f} ms"
            if trunk == "float32" and H == 512 and name == "siren_step":
                line += f"; plain {cs.time_ms(lambda: plain(*args, **fkw), runs=3, warmup=1):.3f} ms"
            print(f"{line}; vs plain {errs}", flush=True)
            if name.endswith("step"):
                print(f"  {name} {trunk} {n_mm} x {H} {dws_split(film, args, fkw, dev)}",
                      flush=True)
            del ops, g, loss_ops, args
            torch.cuda.empty_cache()
    print(cs.card_line())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--anatomy", action="store_true",
                    help="time the anatomy probes in place of the training kernels")
    ap.add_argument("--float32", action="store_true",
                    help="time the Zoo's trunks with the float32 trunk in place of the kernels")
    ap.add_argument("--tiled", action="store_true",
                    help="time the tiled passes' routes in place of the kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = cs.card_line()  # beside chip_smoke's timing lines
    if args.anatomy:
        cs.build_all()
        anatomy(torch.device(cs.DEVICE))
        return 0
    if args.float32:  # builds at first call only what the float32 trunk runs
        float32_zoo(torch.device(cs.DEVICE))
        return 0
    if args.tiled:  # likewise
        tiled(torch.device(cs.DEVICE))
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
                print(f"  siren_step {dws_split(False, ops, kw, dev)}", flush=True)
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
                    print(f"  film_step {dws_split(True, fops, fkw, dev)}", flush=True)
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
