"""One tree's numbers for a parent-against-change comparison on a CUDA card.

    cd <tree root> && python3 <path to this file> TAG [SECTIONS]

Run from the root of each tree (each unpacked by ``git archive``), one
process per tree, in turns (parent, change, change, parent, ...), all on
one card.  Everything it runs is the tree's own: its
``chip_smoke.py`` and the port package found from the working directory.

SECTIONS, comma-separated (default: all, in this order): ``b0`` the b0
train step (32 steps, median of 30, host clock); ``k1k2`` K1 and K2 per
case at B=1 512x1024 with their plain versions and K1's library call (one
``F.conv2d`` with the bias); ``taps4`` the 4-part head at B=1 512x1024;
``stem`` the stem's forward and its backward with the weight grads
at 24x128x128 (the backward on what the tree's forward keeps); each kernel
timed two ways (median CUDA-event ms of 10 back-to-back calls: host issue
included, as ``chip_smoke.median_ms`` times them, and behind a ~10 ms spin
of the card, device time alone); ``serve`` serving frames/s (InterNet,
``--highres_large``, InterStage3Net: 3-step rollouts at 2x512x1024 after a
warm-up); ``modes`` the ``DVIE_BBCHAIN=0 / rest / all`` train steps (median
of 10).  Every line starts with TAG.  Beside each timing a ``card:`` line
gives what ``nvidia-smi`` sampled every 100 ms while it ran: the SM clock
and the power draw (min / median / max), the peak temperature and the
throttle reasons seen, so that a slow run can be told from a slow card.
"""
import os
import statistics
import subprocess
import sys
import threading


class CardSampler:
    """``nvidia-smi``'s SM clock, power draw, temperature and throttle
    reasons of card 0, sampled every 100 ms by a child process for as long
    as the sampler lives; ``span`` sums up the samples taken since its
    last call."""

    FIELDS = ("clocks.sm", "power.draw", "temperature.gpu",
              "clocks_throttle_reasons.active")

    def __init__(self, tag):
        self.tag, self.rows, self.mark = tag, [], 0
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=" + ",".join(self.FIELDS),
             "--format=csv,noheader,nounits", "-lms", "100"], text=True,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.rows.append([v.strip() for v in line.split(",")])

    def span(self, label):
        rows, self.mark = self.rows[self.mark:], len(self.rows)

        def col(i):
            out = []
            for r in rows:
                try:
                    out.append(float(r[i]))
                except (IndexError, ValueError):
                    pass
            return out

        def spread(v, unit):
            return (f"{min(v):.0f} / {statistics.median(v):.0f} / "
                    f"{max(v):.0f} {unit}" if v else "not sampled")

        temp = col(2)
        why = sorted({r[3] for r in rows if len(r) > 3})
        print(f"{self.tag} {label} card: {len(rows)} samples, SM clock "
              f"{spread(col(0), 'MHz')}, power {spread(col(1), 'W')}, "
              f"temperature max {max(temp, default=float('nan')):.0f} C, "
              f"throttle reasons {', '.join(why) or 'not sampled'}",
              flush=True)

    def close(self):
        self.proc.terminate()
        self.proc.wait()


def main():
    sys.path.insert(0, os.getcwd())
    tag = sys.argv[1]
    what = (sys.argv[2] if len(sys.argv) > 2
            else "b0,k1k2,taps4,stem,serve,modes").split(",")
    card_log = CardSampler(tag)
    try:
        run(tag, what, card_log)
    finally:
        card_log.close()


def run(tag, what, card_log):
    import torch

    import chip_smoke as c
    from deep_video_interpolation_extrapolation_tpu_torch.ops import (
        bottleneck_tail as k2,
        conv3x3 as k1,
        trainchain as tc,
        upshead as k4,
    )

    dev = c.require_card()
    card = c.card_line()
    print(f"#### tree {tag} {os.getcwd()} {card}", flush=True)
    c._build.library()
    card_log.span("build")

    if "b0" in what:
        os.environ["DVIE_BBCHAIN"] = "b0"
        _, times, _ = c.trajectory(dev, True, 24, 128, 128, steps=32)
        q = statistics.quantiles(times, n=4)
        print(f"{tag} b0: {24 / statistics.median(times):.4f} samples/s "
              f"(median of {len(times)} steps; step ms quartiles "
              f"{q[0] * 1e3:.3f} / {q[1] * 1e3:.3f} / {q[2] * 1e3:.3f})",
              flush=True)
        card_log.span("b0")

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

    def report(label, kind, fn):
        host = median_ms(fn, False)
        devt = median_ms(fn, True)
        print(f"{tag} {label} {kind}: host-inclusive {host:.4f} ms, "
              f"device {devt:.4f} ms", flush=True)
        card_log.span(f"{label} {kind}")

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
        for label, fns, args in (cases if "k1k2" in what else ()):
            for kind, fn in zip(("kernel", "plain", "library"), fns):
                if fn is not None:
                    report(label, kind, lambda: fn(*args))
        if "taps4" in what:   # the heads of --highres_large
            parts = (x64, rnd(B, H // 2, W // 2, 128),
                     rnd(B, H // 4, W // 4, 256), rnd(B, H // 8, W // 8, 512))
            hw4 = (w(1920, 960, 1, 1)[:, :, 0, 0].t(),
                   w(1920, 1, 1, 1).flatten(),
                   k4.build_dual_tap_kernel(w(3, 960, 3, 3), w(20, 960, 3, 3),
                                            torch.bfloat16))
            report("4-part head", "kernel",
                   lambda: k4.ups_head_taps4(*parts, *hw4))
            del parts
    del x64, x256, res, h1
    torch.cuda.empty_cache()
    if "stem" in what:   # the train stem at the recipe shape
        x14 = rnd(24, 128, 128, 14)
        dy = rnd(24, 128, 128, 64) * 1e-3
        ws = (w(64, 14, 3, 3), w(64, 1, 1, 1).flatten(), w(64, 64, 3, 3),
              w(64, 1, 1, 1).flatten())
        report("stem fwd", "kernel", lambda: tc.stem_fwd_kernel(x14, *ws))
        if hasattr(tc, "stem_bwd_saved_plain"):   # reads s1 and y
            # the train step's forward, which stores s1 for the backward
            report("stem fwd, s1 stored", "kernel",
                   lambda: tc.stem_fwd_kernel(x14, *ws, save=True))
            y, s1 = tc.stem_fwd_kernel(x14, *ws, save=True)
            x16 = tc._pad16(x14)
            report("stem bwd", "kernel",
                   lambda: tc.stem_bwd_kernel(x16, dy, s1, y, *ws))
        else:                                     # recomputes the forward
            report("stem bwd", "kernel",
                   lambda: tc.stem_bwd_kernel(x14, dy, *ws))
        torch.cuda.empty_cache()
    if "serve" in what:
        c.serve_phase(dev, card, label=f"{tag} InterNet")
        card_log.span("InterNet serving")
        c.serve_phase(dev, card, c.CFG_HL, c.PER_FORWARD_HL,
                      f"{tag} highres_large")
        card_log.span("highres_large serving")
        c.serve_phase(dev, card, c.CFG_S3, c.PER_FORWARD_S3, f"{tag} stage3")
        card_log.span("stage3 serving")
    for mode in (("0", "rest", "all") if "modes" in what else ()):
        os.environ["DVIE_BBCHAIN"] = mode
        c._mode_steps(dev, card, f"{tag} {mode}", 24, 128, 128,
                      c.PER_TRAIN_STEP_MODE[mode], steps=12)
        card_log.span(f"mode {mode}")
    print(f"#### tree {tag} done", flush=True)


if __name__ == "__main__":
    main()
