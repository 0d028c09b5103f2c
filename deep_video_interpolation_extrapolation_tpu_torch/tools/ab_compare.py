"""One tree's numbers for a parent-against-change comparison on a CUDA card.

    cd <tree root> && python3 <path to this file> TAG

Run from the root of each tree (each unpacked by ``git archive``), one
process per tree, in turns (parent, change, change, parent, ...), all on
one card.  Everything it runs is the tree's own: its
``chip_smoke.py`` and the port package found from the working directory.

In order: the b0 train step (32 steps, median of 30, host clock), then K1
and K2 per case at B=1 512x1024 with their plain versions and K1's library
call (one ``F.conv2d`` with the bias), each timed two ways (median
CUDA-event ms of 10 back-to-back calls: host issue included, as
``chip_smoke.median_ms`` times them, and behind a ~10 ms spin of the card,
device time alone), then serving frames/s (InterNet, ``--highres_large``,
InterStage3Net: 3-step rollouts at 2x512x1024 after a warm-up) and the
``DVIE_BBCHAIN=0 / rest / all`` train steps (median of 10).  Every line
starts with TAG.
"""
import os
import statistics
import sys


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c
    from deep_video_interpolation_extrapolation_tpu_torch.ops import (
        bottleneck_tail as k2,
        conv3x3 as k1,
    )

    tag = sys.argv[1]
    dev = c.require_card()
    card = c.card_line()
    print(f"#### tree {tag} {os.getcwd()} {card}", flush=True)
    c._build.library()

    os.environ["DVIE_BBCHAIN"] = "b0"
    _, times, _ = c.trajectory(dev, True, 24, 128, 128, steps=32)
    q = statistics.quantiles(times, n=4)
    print(f"{tag} b0: {24 / statistics.median(times):.4f} samples/s "
          f"(median of {len(times)} steps; step ms quartiles "
          f"{q[0] * 1e3:.3f} / {q[1] * 1e3:.3f} / {q[2] * 1e3:.3f})",
          flush=True)

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def w(*shape):
        fan_in = shape[1] * shape[2] * shape[3]
        return torch.randn(shape, generator=g, device=dev) / fan_in ** 0.5

    def median_ms(fn, spin, iters=10, reps=5):
        fn()
        fn()
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(20_000_000)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / iters)
        return statistics.median(out)

    def library(x, w_, b, r, relu):
        return torch.nn.functional.conv2d(
            c.nchw(x), w_.to(x.dtype), None if b is None else b.to(x.dtype),
            padding=1)

    B, H, W = 1, 512, 1024
    x64, x256, res = rnd(B, H, W, 64), rnd(B, H, W, 256), rnd(B, H, W, 64)
    w64, w256 = w(64, 64, 3, 3), w(64, 256, 3, 3)
    bias = w(64, 1, 1, 1).flatten()
    h1 = torch.nn.functional.leaky_relu(rnd(B, H, W, 64), 0.2)
    w2, w3, wres, w1n = (w(64, 64, 3, 3), w(256, 64, 1, 1), w(256, 64, 1, 1),
                         w(64, 256, 1, 1))
    K1 = (k1.conv3x3_bias_res_lrelu, k1.conv3x3_bias_res_lrelu_plain, library)
    K2 = (k2.bottleneck_tail, k2.bottleneck_tail_plain, None)
    cases = [("K1 stem conv2", K1, (x64, w64, bias, None, True)),
             ("K1 trans_0", K1, (x256, w256, None, None, True)),
             ("K1 basicblock conv2", K1, (x64, w64, None, res, True)),
             ("K2 block 0", K2, (h1, x64, w2, w3, wres, w1n)),
             ("K2 block 1", K2, (h1, x256, w2, w3, None, w1n)),
             ("K2 block 3", K2, (h1, x256, w2, w3, None, None))]
    with torch.inference_mode():
        for label, fns, args in cases:
            for kind, fn in zip(("kernel", "plain", "library"), fns):
                if fn is None:
                    continue
                host = median_ms(lambda: fn(*args), False)
                devt = median_ms(lambda: fn(*args), True)
                print(f"{tag} {label} {kind}: host-inclusive {host:.4f} ms, "
                      f"device {devt:.4f} ms", flush=True)
    del x64, x256, res, h1
    torch.cuda.empty_cache()
    c.serve_phase(dev, card, label=f"{tag} InterNet")
    c.serve_phase(dev, card, c.CFG_HL, c.PER_FORWARD_HL,
                  f"{tag} highres_large")
    c.serve_phase(dev, card, c.CFG_S3, c.PER_FORWARD_S3, f"{tag} stage3")
    for mode in ("0", "rest", "all"):
        os.environ["DVIE_BBCHAIN"] = mode
        c._mode_steps(dev, card, f"{tag} {mode}", 24, 128, 128,
                      c.PER_TRAIN_STEP_MODE[mode], steps=12)
    print(f"#### tree {tag} done", flush=True)


if __name__ == "__main__":
    main()
