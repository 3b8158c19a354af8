"""Command-line encoder: y4m in -> IVF out.

Counterpart of the reference's ``rav1e`` binary (src/bin/rav1e.rs,
src/bin/common.rs): same core flags (--speed, --quantizer, --bitrate,
--keyint, --low-latency, --tiles, --verbose, --psnr).  The PyTorch port's
copy adds --device, the torch device of the device stages: the card
(``Config``'s default, "cuda") unless ``--device cpu`` asks for the CPU; a
missing card is an InvalidConfig, never a CPU run.  --benchmark also
prints the hand-written kernels' launch counts.

Usage: python -m rav1e_tpu_torch.cli input.y4m -o output.ivf [--speed 6] ...
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from rav1e_tpu_torch import Config, EncoderConfig, EncoderStatus
from rav1e_tpu_torch.config.encoder import Rational
from rav1e_tpu_torch.io import IvfWriter, Y4MReader


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rav1e-tpu", description=__doc__)
    p.add_argument("input", help="input file (y4m)")
    p.add_argument("-o", "--output", required=True, help="output file (ivf)")
    p.add_argument("-s", "--speed", type=int, default=6, help="speed preset 0-10")
    p.add_argument("-q", "--quantizer", type=int, default=100, help="quantizer 0-255")
    p.add_argument("-b", "--bitrate", type=int, default=0, help="target bitrate (kbps)")
    p.add_argument("-i", "--min-keyint", type=int, default=12)
    p.add_argument("-I", "--keyint", type=int, default=240)
    p.add_argument("--low-latency", action="store_true")
    p.add_argument("--still-picture", action="store_true")
    p.add_argument("--tiles", type=int, default=0)
    p.add_argument("--tile-rows", type=int, default=0)
    p.add_argument("--tile-cols", type=int, default=0)
    p.add_argument("-l", "--limit", type=int, default=0, help="max frames to encode")
    p.add_argument("--first-pass", metavar="FILE",
                   help="write first-pass rate stats to FILE (2-/3-pass)")
    p.add_argument("--second-pass", metavar="FILE",
                   help="read rate stats from FILE; combined with "
                   "--first-pass this is the middle pass of a 3-pass encode "
                   "(reference bin/common.rs:86-95)")
    p.add_argument("-r", "--reconstruction", metavar="FILE",
                   help="write the reconstruction as y4m to FILE")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override a speed-settings field by dotted name "
                   "(e.g. motion.me_method=2, cdef=false; bin/kv.rs analog)")
    p.add_argument("--psnr", action="store_true", help="print per-frame PSNR")
    p.add_argument("--metrics", action="store_true", help="print per-frame PSNR/SSIM/MS-SSIM")
    p.add_argument("--benchmark", action="store_true", help="print fps at end")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", help="torch device of the device stages: "
                   "cuda (the default), cuda:N or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.benchmark:
        from rav1e_tpu_torch.utils.trace import trace_enable

        trace_enable()

    with open(args.input, "rb") as fin:
        y4m = Y4MReader(fin)
        enc = EncoderConfig(
            width=y4m.width,
            height=y4m.height,
            bit_depth=y4m.bit_depth,
            chroma_sampling=y4m.chroma_sampling,
            time_base=Rational(y4m.fps_den, y4m.fps_num),
            quantizer=args.quantizer,
            bitrate=args.bitrate * 1000,
            low_latency=args.low_latency,
            still_picture=args.still_picture,
            tiles=args.tiles,
            tile_rows=args.tile_rows,
            tile_cols=args.tile_cols,
        )
        enc.set_key_frame_interval(args.min_keyint, args.keyint)
        kw = {} if args.device is None else {"device": args.device}
        cfg = Config(enc=enc, **kw).with_speed_preset(args.speed)
        for kv in args.set:
            _apply_speed_override(cfg.enc.speed_settings, kv)
        ctx = cfg.new_context()

        if args.second_pass:
            with open(args.second_pass, "rb") as fpass:
                n = ctx.twopass_in(fpass.read())
            if args.verbose:
                print(f"loaded {n} first-pass frame records", file=sys.stderr)

        recon_out = None
        if args.reconstruction:
            recon_out = open(args.reconstruction, "wb")
            _write_y4m_header(recon_out, y4m)

        t0 = time.monotonic()
        nframes = 0
        sources = {}
        with open(args.output, "wb") as fout:
            ivf = IvfWriter(fout, y4m.width, y4m.height, y4m.fps_num, y4m.fps_den)
            for planes in y4m:
                if args.limit and nframes >= args.limit:
                    break
                f = ctx.new_frame()
                for plane, arr in zip(f.planes, planes):
                    plane.copy_from(arr)
                ctx.send_frame(f)
                if args.psnr or args.metrics:
                    sources[nframes] = planes
                nframes += 1
                _drain(ctx, ivf, args, sources, recon_out=recon_out)
                if args.still_picture:
                    break
            ctx.flush()
            _drain(ctx, ivf, args, sources, flushing=True, recon_out=recon_out)
            ivf.close()
        if recon_out is not None:
            recon_out.close()
        if args.first_pass:
            data = ctx.twopass_out()
            if data is not None:
                with open(args.first_pass, "wb") as fpass:
                    fpass.write(data)
        dt = time.monotonic() - t0
        if args.benchmark or args.verbose:
            print(
                f"encoded {nframes} frames in {dt:.2f}s ({nframes / dt:.3f} fps)",
                file=sys.stderr,
            )
        if args.benchmark:
            from rav1e_tpu_torch.utils.trace import stage_summary, trace_enabled

            if trace_enabled():
                for name, s in stage_summary().items():
                    print(
                        f"  {name}: {s['total_ms']:.1f} ms total, "
                        f"{s['mean_ms']:.2f} ms/call x{s['count']}",
                        file=sys.stderr,
                    )
            from rav1e_tpu_torch.device.kernels import LAUNCHES

            print("  kernel launches: " + " ".join(
                f"{k}={v}" for k, v in LAUNCHES.items()), file=sys.stderr)
    return 0


def _apply_speed_override(ss, kv: str) -> None:
    """Dotted key=value override of SpeedSettings fields (bin/kv.rs analog):
    `--set motion.me_method=2`, `--set cdef=false`."""
    key, _, value = kv.partition("=")
    if not value:
        raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
    obj = ss
    parts = key.strip().split(".")
    for part in parts[:-1]:
        if not hasattr(obj, part):
            raise SystemExit(f"unknown speed setting group {part!r}")
        obj = getattr(obj, part)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise SystemExit(f"unknown speed setting {key!r}")
    cur = getattr(obj, leaf)
    v = value.strip()
    if isinstance(cur, bool):
        setattr(obj, leaf, v.lower() in ("1", "true", "yes", "on"))
    elif isinstance(cur, int):
        setattr(obj, leaf, int(v))
    else:
        import enum

        if isinstance(cur, enum.IntEnum):
            setattr(obj, leaf, type(cur)(int(v)))
        else:
            raise SystemExit(f"cannot override {key!r} (type {type(cur).__name__})")


def _write_y4m_header(fh, y4m) -> None:
    cs_tag = {0: "420jpeg", 1: "422", 2: "444", 3: "mono"}
    cs = cs_tag.get(int(y4m.chroma_sampling), "420jpeg")
    if y4m.bit_depth > 8:
        cs = {"420jpeg": "420", "422": "422", "444": "444"}.get(cs, cs) + f"p{y4m.bit_depth}"
    fh.write(
        f"YUV4MPEG2 W{y4m.width} H{y4m.height} "
        f"F{y4m.fps_num}:{y4m.fps_den} Ip A1:1 C{cs}\n".encode()
    )


def _write_y4m_frame(fh, rec, width, height) -> None:
    fh.write(b"FRAME\n")
    for p in rec.planes:
        xd, yd = p.cfg.xdec, p.cfg.ydec
        w = (width + xd) >> xd
        h = (height + yd) >> yd
        fh.write(np.ascontiguousarray(p.as_array()[:h, :w]).tobytes())


def _drain(ctx, ivf, args, sources, flushing=False, recon_out=None) -> None:
    while True:
        try:
            pkt = ctx.receive_packet()
        except EncoderStatus.NeedMoreData:
            return
        except EncoderStatus.LimitReached:
            return
        ivf.write_frame(pkt.data, pkt.input_frameno)
        if recon_out is not None and pkt.rec is not None and pkt.show_frame:
            _write_y4m_frame(
                recon_out, pkt.rec, ctx.config.enc.width, ctx.config.enc.height
            )
        if args.verbose:
            print(
                f"frame {pkt.input_frameno} {pkt.frame_type.name} qp={pkt.qp} "
                f"{len(pkt.data)} bytes",
                file=sys.stderr,
            )
        if args.metrics and pkt.rec is not None:
            src = sources.get(pkt.input_frameno)
            if src is not None:
                from rav1e_tpu_torch.utils.metrics import frame_metrics

                m = frame_metrics(
                    [a for a in src],
                    [p.as_array() for p in pkt.rec.planes],
                    ctx.config.enc.bit_depth,
                )
                print(
                    f"frame {pkt.input_frameno} "
                    + " ".join(f"{k}={v:.4f}" for k, v in m.items()),
                    file=sys.stderr,
                )
        if not args.psnr:
            sources.pop(pkt.input_frameno, None)
        if args.psnr and pkt.rec is not None:
            src = sources.pop(pkt.input_frameno, None)
            if src is not None:
                vals = []
                peak = (1 << ctx.config.enc.bit_depth) - 1
                for plane, arr in zip(pkt.rec.planes, src):
                    mse = np.mean(
                        (plane.as_array().astype(np.float64) - arr.astype(np.float64)) ** 2
                    )
                    vals.append(10 * np.log10(peak * peak / mse) if mse > 0 else 99.0)
                print(
                    f"frame {pkt.input_frameno} PSNR: "
                    + " ".join(f"{v:.2f}" for v in vals),
                    file=sys.stderr,
                )


if __name__ == "__main__":
    sys.exit(main())
